"""Evolutionary layout search: sweep candidate sharding plans on measured
step time. The port of ``agilerl_tpu/parallel/layout_search.py``.

The ``sharding=`` mutation (``hpo/mutation.py``) swaps a member's layout
among the registered plans and lets tournament pressure feel the
difference through :class:`~agilerl_tpu_torch.observability.timeline.StepTimeline`
step-time telemetry. :func:`search_layouts` runs the sweep: the candidates
default to the registry's plans for the live device count (exactly the
mutation's swap set, seeded with the default GRPO layouts), each step runs
through :func:`~agilerl_tpu_torch.parallel.plan.compile_step_with_plan`,
fitness is the mean measured step time over ``steps`` timed calls (after
``warmup`` untimed ones), each call ended on a sync of its outputs'
devices, and the result ranks the candidates fastest first.

The JAX sweep also pays (or loads from its executable store) one XLA
compile per layout; the port's steps run eagerly, so there is no program to
store: ``cache=`` other than None raises ``NotImplementedError`` (see
:mod:`~agilerl_tpu_torch.parallel.compile_cache`), and each candidate's cache
fields stay None.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from agilerl_tpu_torch.parallel import plan as PL


@dataclass
class LayoutCandidate:
    """One evaluated layout: the plan, its measured step times, and the
    compile-cache provenance of its program (None in the port)."""

    plan: Any
    step_times_s: List[float] = field(default_factory=list)
    step_time_s: Optional[float] = None  # mean over the timed calls
    cache_hit: Optional[bool] = None
    load_s: Optional[float] = None
    compile_s: Optional[float] = None
    fingerprint: Optional[str] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None and self.step_time_s is not None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "plan": self.plan.name,
            "mesh": dict(self.plan.ordered_axes()),
            "step_time_s": self.step_time_s,
            "step_times_s": list(self.step_times_s),
            "cache_hit": self.cache_hit,
            "load_s": self.load_s,
            "compile_s": self.compile_s,
            "fingerprint": self.fingerprint,
            "error": self.error,
        }


@dataclass
class LayoutSearchResult:
    candidates: List[LayoutCandidate]

    @property
    def ranked(self) -> List[LayoutCandidate]:
        """Successful candidates, fastest mean step time first."""
        return sorted((c for c in self.candidates if c.ok),
                      key=lambda c: c.step_time_s)

    @property
    def best(self) -> Optional[LayoutCandidate]:
        ranked = self.ranked
        return ranked[0] if ranked else None

    def to_dict(self) -> Dict[str, Any]:
        best = self.best
        return {
            "best_plan": best.plan.name if best is not None else None,
            "candidates": [c.to_dict() for c in self.ranked]
            + [c.to_dict() for c in self.candidates if not c.ok],
        }


def sync_outputs(out: Any) -> None:
    """Block until every CUDA tensor in ``out`` is computed (the
    counterpart of ``jax.block_until_ready``): one synchronize per card the
    outputs live on. Host values need nothing."""
    from agilerl_tpu_torch.utils.tree import tree_leaves

    devices = set()
    for leaf in tree_leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            devices.add(leaf.device)
    for dev in devices:
        # the timing boundary itself: one wait per card the outputs live on
        torch.cuda.synchronize(dev)  # graftcheck: disable=GX001


def search_layouts(
    step_fn: Callable,
    in_groups: Sequence[Optional[str]],
    args_for: Any,
    *,
    plans: Optional[Sequence[Any]] = None,
    device: Any = None,
    mesh: Any = None,
    cache: Any = None,
    steps: int = 3,
    warmup: int = 1,
    donate: bool = False,
    registry=None,
    name: str = "layout_search",
) -> LayoutSearchResult:
    """Evaluate ``step_fn`` under each candidate plan and rank by measured
    step time.

    - ``args_for``: either a tuple of concrete arg trees (placed per plan
      through ``step.place_args`` for every candidate) or a callable
      ``args_for(plan, mesh) -> args tuple`` for layouts that need
      per-plan inputs (an agent placed by the plan, per-layout batches).
    - ``plans``: candidate :class:`~agilerl_tpu_torch.parallel.plan.ShardingPlan`
      objects or registered names; default = the registry's plans for the
      live device count (``register_default_plans(n)`` first) — the
      sharding mutation's swap set. Each plan's mesh is built over the
      process group (``device``: None is the card, ``"cpu"`` gloo ranks).
    - ``mesh``: one ``DeviceMesh`` for every candidate instead, each plan's
      rules shaped to it (axes the mesh does not carry replicate, as in
      ``GRPO.to_mesh(mesh=, plan=)``); the default candidates are then the
      plans for its size.
    - ``cache``: must be None — the port has no executable store for its
      eager steps (``NotImplementedError`` otherwise).
    - ``donate``: the step consumes its first arg (training-step
      convention); args are rebuilt before EVERY call, outside the timed
      region, so a consumed input is never measured twice.

    A candidate whose step raises is recorded with its error and excluded
    from the ranking — one invalid layout must not kill the sweep. Step
    times feed one :class:`~agilerl_tpu_torch.observability.timeline.StepTimeline`
    per candidate (``<name>/<plan>``) plus one ``<name>`` event per
    candidate and the ``<name>/best_step_time_s`` gauge.
    """
    from agilerl_tpu_torch import observability
    from agilerl_tpu_torch.observability.timeline import StepTimeline

    if cache is not None:
        raise NotImplementedError(
            "search_layouts(cache=): the port runs its steps eagerly and has "
            "no executable store for them")
    reg = registry if registry is not None else observability.get_registry()
    if plans is None:
        n = mesh.size() if mesh is not None else PL.live_device_count()
        PL.register_default_plans(n)
        plans = PL.plans_for_device_count(n)
    plans = [PL.get_plan(p) if isinstance(p, str) else p for p in plans]
    if not plans:
        raise ValueError(
            "layout search needs at least one candidate plan (register "
            "plans for this device count, or pass plans=)")

    candidates: List[LayoutCandidate] = []
    n_warm, n_timed = int(warmup), int(steps)
    for plan in plans:
        cand = LayoutCandidate(plan=plan)
        candidates.append(cand)
        try:
            step = PL.compile_step_with_plan(step_fn, plan, in_groups, mesh=mesh,
                                             device=device, name=f"{name}/{plan.name}")

            def build_args() -> Tuple[Any, ...]:
                raw = (args_for(plan, step.mesh) if callable(args_for)
                       else args_for)
                return step.place_args(*raw) + tuple(raw[len(step.in_groups):])

            timeline = StepTimeline(reg, name=f"{name}/{plan.name}",
                                    step_event_every=0)
            timeline.step()  # arm the interval timer
            args = None
            for i in range(n_warm + n_timed):
                if donate or args is None:
                    args = build_args()
                t0 = time.perf_counter()
                out = step(*args)
                sync_outputs(out)
                dt = time.perf_counter() - t0
                if i >= n_warm:
                    cand.step_times_s.append(dt)
                    timeline.step()
            cand.step_time_s = (sum(cand.step_times_s)
                                / max(len(cand.step_times_s), 1))
        except Exception as e:  # noqa: BLE001 — one bad layout != dead sweep
            cand.error = f"{type(e).__name__}: {e}"
            reg.warn_once(
                f"layout-search-{plan.name}",
                f"layout search candidate {plan.name!r} failed: {cand.error}")
        reg.emit(name, **cand.to_dict())

    result = LayoutSearchResult(candidates)
    best = result.best
    if best is not None:
        reg.gauge(f"{name}/best_step_time_s").set(best.step_time_s)
        reg.emit(f"{name}_summary", **result.to_dict())
    return result
