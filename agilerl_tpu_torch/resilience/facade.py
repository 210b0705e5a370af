"""The one resilience object a training loop talks to: the port of
``agilerl_tpu/resilience/facade.py`` (whole).

``Resilience`` wires the :class:`~agilerl_tpu_torch.resilience.snapshot.CheckpointManager`
(crash-consistent whole-run snapshots), the
:class:`~agilerl_tpu_torch.resilience.preemption.PreemptionGuard` (SIGTERM/SIGINT →
final snapshot at the next step boundary) and the retry policies into the
``resilience=`` / ``resume=`` kwargs every loop in
``agilerl_tpu_torch/training/`` exposes::

    res = Resilience("runs/exp1/snapshots", save_every=10_000)
    pop, fit = train_off_policy(env, ..., resilience=res, resume=True)

On resume the loop's population, replay buffers, random streams (per-agent
torch and numpy Generators, numpy/python globals, the env's stream, the
tournament/mutation streams), lineage genealogy and loop counters are all
restored from the latest COMPLETE snapshot. Cadence snapshots are only ever
taken at generation boundaries (the loops' re-entry points), so a run
resumed from one continues the same step/fitness stream the uninterrupted
run would have produced. A population program (``parallel/generation.ScanRun``)
follows the same capture protocol: ``attach(pop=[run])`` snapshots it.

Preemption snapshots follow ``on_preempt``:

* ``"now"`` (default): the final snapshot is taken at the next step
  boundary, mid-generation — minimal grace-window usage, maximal work
  preserved. The loops can only re-enter at a generation boundary, so the
  resumed run replays the partial generation from the snapshotted state: a
  valid continuation, but not the bit-identical stream.
* ``"finish_generation"``: the current generation (including eval and
  evolution) completes first and the final snapshot lands on the
  generation boundary — the resumed run continues the exact stream, at the
  cost of up to one generation of grace window.

A snapshot is never taken on another device than the run's, and a failed
restore of an agent, an env stream or a generator raises: nothing goes on
with a fresh state.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

from agilerl_tpu_torch.resilience.preemption import PreemptionGuard
from agilerl_tpu_torch.resilience.retry import RetryPolicy, RetryingEnv
from agilerl_tpu_torch.resilience.snapshot import (
    CheckpointManager,
    capture_agent,
    capture_buffers,
    capture_env_rng,
    capture_evolution,
    capture_host_rng,
    restore_agent,
    restore_buffers,
    restore_env_rng,
    restore_evolution,
    restore_host_rng,
)

_SAVE_COUNT_KEY = "_resilience_save_count"


class Resilience:
    """Crash-consistency + preemption-awareness for one training run.

    Parameters
    ----------
    directory:
        Snapshot root (one run per directory).
    save_every:
        Snapshot cadence in env steps, applied at the loops' step boundaries
        (the generation/evaluation boundary — the only points where a
        snapshot is deterministic to resume). ``None`` disables cadence
        snapshots; preemption snapshots still fire.
    keep_last / keep_best:
        Retention: the last K snapshots plus the best-fitness one survive.
    handle_signals:
        Install the SIGTERM/SIGINT :class:`PreemptionGuard` while attached
        to a run (restored on ``close()``).
    retry:
        Optional :class:`RetryPolicy` used by :meth:`wrap_env`.
    on_preempt:
        What a preemption request interrupts. ``"now"`` (default) aborts
        the generation in flight and snapshots at the next step boundary —
        fastest exit, but the resumed run replays the partial generation
        rather than continuing the identical stream. ``"finish_generation"``
        lets the generation (plus eval/evolution) complete so the final
        snapshot lands on a generation boundary and the resume is
        bit-deterministic.
    """

    ON_PREEMPT_MODES = ("now", "finish_generation")

    def __init__(
        self,
        directory: Union[str, Path],
        *,
        save_every: Optional[int] = None,
        keep_last: int = 3,
        keep_best: bool = True,
        handle_signals: bool = True,
        retry: Optional[RetryPolicy] = None,
        on_preempt: str = "now",
        manager: Optional[CheckpointManager] = None,
        registry=None,
    ):
        if on_preempt not in self.ON_PREEMPT_MODES:
            raise ValueError(
                f"on_preempt must be one of {self.ON_PREEMPT_MODES}, "
                f"got {on_preempt!r}"
            )
        self.on_preempt = on_preempt
        self.manager = manager or CheckpointManager(
            directory, keep_last=keep_last, keep_best=keep_best,
            registry=registry,
        )
        self.save_every = None if save_every is None else max(int(save_every), 1)
        self.retry = retry
        self.guard = PreemptionGuard(registry=registry)
        self._handle_signals = bool(handle_signals)
        self._save_count = 0
        # live run references (attach() wires them; step_boundary re-wires
        # pop, which evolution rebinds every generation)
        self._pop: Optional[List] = None
        self._memory = None
        self._n_step_memory = None
        self._tournament = None
        self._mutation = None
        self._telemetry = None
        self._env = None

    # -- run wiring -------------------------------------------------------- #
    def attach(
        self,
        pop: Optional[List] = None,
        memory=None,
        n_step_memory=None,
        tournament=None,
        mutation=None,
        telemetry=None,
        env=None,
    ) -> "Resilience":
        """Point this object at the live run (called by the training loops
        right after telemetry init)."""
        self._pop = pop
        self._memory = memory
        self._n_step_memory = n_step_memory
        self._tournament = tournament
        self._mutation = mutation
        self._telemetry = telemetry
        self._env = env
        if telemetry is not None:
            # route snapshot/preemption events into the run's sink
            self.manager._registry = telemetry.registry
            self.guard._registry = telemetry.registry
            self.guard.telemetry = telemetry
        # a reused Resilience object must not replay the previous run's
        # latched preemption — the fresh run would exit before step one —
        # nor carry its cadence counter: a fresh run starting at step 0
        # would otherwise take no cadence snapshot until it passed the
        # previous run's last save step (resume() re-seeds it from the
        # snapshot when one exists)
        self.guard.reset()
        self._save_count = 0
        if self._handle_signals:
            self.guard.install()
        return self

    def wrap_env(self, env):
        """Wrap ``env`` with the retry policy (identity when none is set)."""
        if self.retry is None:
            return env
        return RetryingEnv(env, policy=self.retry,
                           registry=self.manager._registry)

    @property
    def registry(self):
        return self.manager.registry

    @property
    def preempted(self) -> bool:
        """True once SIGTERM/SIGINT (or ``guard.request()``) asked for a
        final snapshot — loops check this at step boundaries."""
        return self.guard.requested

    @property
    def abort_generation(self) -> bool:
        """The loops' MID-generation preemption check: True only when a
        preemption was requested AND ``on_preempt="now"``. Under
        ``"finish_generation"`` this stays False so the generation (plus
        eval/evolution) completes and :meth:`step_boundary` takes the final
        snapshot at the generation boundary — the deterministic re-entry
        point."""
        return self.on_preempt == "now" and self.guard.requested

    def _lineage(self):
        if self._telemetry is not None and self._telemetry.lineage is not None:
            return self._telemetry.lineage
        return getattr(self._tournament, "lineage", None)

    # -- snapshot/restore --------------------------------------------------- #
    def snapshot(
        self,
        step: int,
        counters: Optional[Dict[str, Any]] = None,
        kind: str = "cadence",
        fitness: Optional[float] = None,
    ) -> Path:
        """Capture and atomically commit the whole-run state. The staging
        rings are drained first (reusing the buffers' ``stage()``/``flush()``
        machinery) so both paired rings land index-aligned."""
        from agilerl_tpu_torch.components.replay_buffer import drain_staging

        drain_staging(self._memory, self._n_step_memory)
        entries: Dict[str, Any] = {
            "population": [capture_agent(a) for a in (self._pop or [])],
            "buffers": capture_buffers(
                memory=self._memory, n_step_memory=self._n_step_memory
            ),
            "rng": capture_host_rng(),
            "evolution": capture_evolution(
                self._tournament, self._mutation, self._lineage()
            ),
            "counters": {**(counters or {}), _SAVE_COUNT_KEY: self._save_count},
        }
        if self._env is not None:
            env_blob = capture_env_rng(self._env)
            if env_blob is not None:
                entries["env"] = env_blob
        path = self.manager.save(entries, step, kind=kind, fitness=fitness)
        self.registry.emit(
            "snapshot", step=int(step), snapshot_kind=kind, path=str(path),
            fitness=None if fitness is None else float(fitness),
        )
        return path

    def resume(self, counters: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Restore the attached run from the latest complete snapshot.

        Returns the loop counters: the caller's defaults merged under the
        snapshot's saved values (unchanged when no snapshot exists, so a
        fresh run with ``resume=True`` just starts cleanly)."""
        merged = dict(counters or {})
        loaded = self.manager.load()
        if loaded is None:
            return merged
        info, entries = loaded
        saved_pop = entries.get("population", [])
        live_pop = self._pop or []
        if len(saved_pop) != len(live_pop):
            self.registry.warn_once(
                "resilience:population_size_mismatch",
                f"snapshot holds {len(saved_pop)} agents, live population has "
                f"{len(live_pop)} — restoring the overlapping prefix",
            )
        for agent, blob in zip(live_pop, saved_pop):
            restore_agent(agent, blob)
        restore_buffers(
            entries.get("buffers"),
            memory=self._memory, n_step_memory=self._n_step_memory,
        )
        restore_host_rng(entries.get("rng"))
        restore_env_rng(self._env, entries.get("env"))
        restore_evolution(
            entries.get("evolution"), self._tournament, self._mutation,
            self._lineage(),
        )
        saved_counters = dict(entries.get("counters", {}))
        self._save_count = int(saved_counters.pop(_SAVE_COUNT_KEY, 0))
        for key, saved in saved_counters.items():
            live = merged.get(key)
            if (
                isinstance(saved, list) and isinstance(live, list)
                and len(saved) == len(saved_pop) != 0
                and len(live) == len(live_pop)
                and len(live) > len(saved)
            ):
                # a per-agent counter (e.g. pop_fitnesses) from a smaller
                # snapshot population: honor the prefix-restore contract
                # warned about above — saved values for the overlapping
                # agents, the caller's defaults for the extras (a wholesale
                # replace would hand the loop a too-short list and crash its
                # first eval round)
                merged[key] = list(saved) + list(live[len(saved):])
            else:
                merged[key] = saved
        self.registry.emit(
            "resume", step=info.step, snapshot_kind=info.kind,
            path=str(info.path),
        )
        return merged

    # -- the loops' boundary hook ------------------------------------------ #
    def step_boundary(
        self,
        step: int,
        counters: Optional[Dict[str, Any]] = None,
        pop: Optional[List] = None,
        fitness: Optional[float] = None,
    ) -> bool:
        """Called once per step boundary (the loops' old ad-hoc checkpoint
        site). Takes a cadence snapshot when due, or the FINAL snapshot when
        a preemption was requested — in which case it returns True and the
        loop exits cleanly."""
        if pop is not None:
            self._pop = pop
        if fitness is not None and not np.isfinite(fitness):
            fitness = None  # NaN/inf must not poison best-fitness retention
        if self.guard.requested:
            self.snapshot(step, counters, kind="preempt", fitness=fitness)
            return True
        if self.save_every is not None and step // self.save_every > self._save_count:
            self._save_count = step // self.save_every
            self.snapshot(step, counters, kind="cadence", fitness=fitness)
        return False

    def close(self) -> None:
        """Detach from the run: restore signal handlers and drop the run
        references attach() took — a Resilience object kept around between
        sequential runs must not pin the previous run's replay-buffer rings
        and population trees until the next attach()."""
        self.guard.uninstall()
        self._pop = None
        self._memory = None
        self._n_step_memory = None
        self._tournament = None
        self._mutation = None
        self._telemetry = None
        self._env = None

    def __enter__(self) -> "Resilience":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def max_fitness(fitnesses) -> Optional[float]:
    """Small shared helper: best fitness of an eval round (None when the
    round produced nothing finite) — feeds the keep-best retention.
    Accepts any sequence, including numpy arrays (whose truth value is
    ambiguous, so no ``if fitnesses`` here)."""
    arr = np.asarray(list(fitnesses), dtype=float)
    if arr.size == 0 or not np.isfinite(arr).any():
        return None
    return float(np.nanmax(arr[np.isfinite(arr)]))
