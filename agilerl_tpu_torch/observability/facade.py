"""The one logging facade every training loop talks to: the port of
``agilerl_tpu/observability/facade.py``.

A loop builds ONE :class:`RunTelemetry` (or receives one via its
``telemetry=`` kwarg) and routes metrics through
:meth:`RunTelemetry.log_step`; they reach the registry and the JSONL sink.
``wb=True`` (wandb) raises ``NotImplementedError`` until the distribution
slice, as the port's other loops do.

``get_registry`` / ``warn_once`` live in ``registry.py`` (their one home in
the port) and are re-exported here.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from agilerl_tpu_torch.observability.events import JsonlSink, NullSink
from agilerl_tpu_torch.observability.lineage import LineageTracker
from agilerl_tpu_torch.observability.registry import (  # noqa: F401 (re-exported)
    MetricsRegistry,
    get_registry,
    warn_once,
)
from agilerl_tpu_torch.observability.timeline import StepTimeline

#: env var: write run telemetry JSONL here when no explicit path is given
#: (a directory gets one file per run; a ``.jsonl`` path is used verbatim)
TELEMETRY_ENV = "AGILERL_TPU_TELEMETRY"
#: env var: emit a JSONL ``step`` event every N steps (default 1). Hot
#: per-env-step loops with a JsonlSink should raise this — each step event
#: is a flushed disk write. 0 disables step events; aggregates stay exact.
STEP_EVERY_ENV = "AGILERL_TPU_TELEMETRY_STEP_EVERY"
#: env var: distributed-tracing sample rate (a float in [0, 1]; 0 =
#: anomaly-only — forced spans still record). Requires a live JSONL sink
#: (``AGILERL_TPU_TELEMETRY`` or an explicit ``jsonl_path``): spans ride
#: the same event stream. Unset = tracing stays a no-op.
TRACE_ENV = "AGILERL_TPU_TRACE"


def _resolve_jsonl_path(jsonl_path: Optional[str]) -> Optional[str]:
    path = jsonl_path or os.environ.get(TELEMETRY_ENV)
    if not path:
        return None
    if path.endswith(".jsonl"):
        return path
    os.makedirs(path, exist_ok=True)
    import time

    return os.path.join(path, f"run-{os.getpid()}-{int(time.time())}.jsonl")


class RunTelemetry:
    """Registry + sink + lineage + step timeline, for one training run."""

    def __init__(
        self,
        wb: bool = False,
        config: Optional[Dict] = None,
        jsonl_path: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
        lineage: bool = True,
        name: str = "train",
        model_config=None,
        step_event_every: Optional[int] = None,
        project: str = "agilerl-tpu",
        trace: Optional[float] = None,
    ):
        if wb:
            raise NotImplementedError(
                "RunTelemetry wb=True (wandb) is not ported yet (distribution slice)")
        if step_event_every is None:
            step_event_every = int(os.environ.get(STEP_EVERY_ENV, "1") or 1)
        self.registry = registry or MetricsRegistry()
        self._closed = False
        path = _resolve_jsonl_path(jsonl_path)
        sink = self.registry.sink
        # attach a live sink when: the registry has none, a previous run's
        # sink was closed, or a JSONL path is requested but only a NullSink
        # is attached (a live JsonlSink from the caller is respected)
        if (sink is None or getattr(sink, "closed", False)
                or (path and isinstance(sink, NullSink))):
            self.registry.attach_sink(JsonlSink(path) if path else NullSink())
            if path:
                # a crashed/interrupted run still gets its lineage_summary at
                # process exit; close() is idempotent so a normal close wins
                import atexit
                import weakref

                ref = weakref.ref(self)
                atexit.register(lambda: ref() and ref().close())
        self.lineage = LineageTracker(self.registry) if lineage else None
        if self.lineage is not None:
            # marks the tracker as facade-owned: attach_evolution may replace
            # it on HPO objects reused across runs (a user-wired tracker is
            # never clobbered)
            self.lineage._facade_owned = True
        self.timeline = StepTimeline(
            self.registry, name=name, model_config=model_config,
            step_event_every=step_event_every)
        # -- distributed tracing: spans ride the run's event sink. The
        # configured tracer is ALSO installed as the process default so
        # tracer-less components (fleet replicas, flywheel pods, elastic
        # controllers) pick it up through trace.get_tracer(); close()
        # restores the previous default.
        if trace is None:
            env_rate = os.environ.get(TRACE_ENV)
            if env_rate:
                trace = float(env_rate)
        self.tracer = None
        self._prev_tracer = None
        # trace=0.0 is a VALID configuration (anomaly-only: forced spans
        # still record) — only None/False leave tracing off
        if trace is not None and trace is not False:
            from agilerl_tpu_torch.observability.trace import Tracer, set_tracer

            rate = 1.0 if trace is True else float(trace)
            sink = self.registry.sink
            if sink is not None and not isinstance(sink, NullSink):
                self.tracer = Tracer(sink=sink, sample_rate=rate,
                                     pod=f"{name}-{os.getpid()}",
                                     metrics=self.registry)
                self._prev_tracer = set_tracer(self.tracer)
        if config:
            self.registry.emit("run_config", config=config)

    # -- the deduplicated per-loop logging surface -------------------------
    def log_step(self, metrics: Dict[str, Any], kind: str = "metrics") -> None:
        """Route one metrics dict to the event sink."""
        self.registry.emit(kind, **metrics)

    def step(self, **kwargs) -> Optional[Dict[str, Any]]:
        """Per-training-step timeline tick (see StepTimeline.step)."""
        return self.timeline.step(**kwargs)

    def record_eval(self, pop: List, fitnesses: List[float]) -> None:
        """Feed an evaluation's fitnesses to the lineage tracker (closing out
        the previous generation's parent→child records) and emit an ``eval``
        event."""
        if self.lineage is not None:
            for agent, f in zip(pop, fitnesses):
                self.lineage.record_fitness(agent.index, float(f))
        if fitnesses:
            mean = float(sum(float(f) for f in fitnesses) / len(fitnesses))
            self.registry.gauge("eval/mean_fitness").set(mean)
            self.registry.emit(
                "eval",
                mean_fitness=mean,
                fitnesses=[float(f) for f in fitnesses],
                agents=[int(a.index) for a in pop],
            )

    def attach_evolution(self, tournament, mutation) -> None:
        """Point the HPO machinery's lineage hooks at this run's tracker."""
        if self.lineage is None:
            return

        def _attachable(obj):
            existing = getattr(obj, "lineage", None)
            # replace nothing the caller wired in explicitly; a facade-owned
            # tracker from a PREVIOUS run must be replaced or generation
            # events would land in that run's closed sink
            return existing is None or getattr(existing, "_facade_owned", False)

        if tournament is not None and _attachable(tournament):
            tournament.lineage = self.lineage
        if mutation is not None and _attachable(mutation):
            mutation.lineage = self.lineage

    def close(self, lineage_path: Optional[str] = None) -> None:
        if self._closed:
            return
        self._closed = True
        if self.tracer is not None:
            from agilerl_tpu_torch.observability import trace as _trace

            # only restore if this run's tracer is still the default (a
            # later run may have installed its own — don't clobber it)
            if _trace.get_tracer() is self.tracer:
                _trace.set_tracer(self._prev_tracer)
            self.tracer = None
        if self.lineage is not None:
            if lineage_path:
                self.lineage.dump(lineage_path)
            self.registry.emit("lineage_summary",
                               mutation_effects=self.lineage.mutation_effects())
        sink = self.registry.sink
        if sink is not None:
            sink.close()


def init_run_telemetry(
    wb: bool = False,
    config: Optional[Dict] = None,
    telemetry: Optional[RunTelemetry] = None,
    **kwargs,
) -> RunTelemetry:
    """The loops' one-liner: reuse a caller-supplied RunTelemetry or build a
    fresh one (JSONL when configured via arg/env)."""
    if telemetry is not None:
        return telemetry
    return RunTelemetry(wb=wb, config=config, **kwargs)
