"""Telemetry of the port: the metrics registry, JSONL events, step/MFU
timelines, evolution lineage, distributed tracing, the cross-process
telemetry plane and declarative SLOs. The port of
``agilerl_tpu/observability/`` (every module; ``get_registry``/``warn_once``
live in ``registry.py`` and the facade re-exports them)."""

from agilerl_tpu_torch.observability.events import (
    JsonlSink,
    MemorySink,
    NullSink,
    read_jsonl,
)
from agilerl_tpu_torch.observability.export import (
    TelemetryAggregator,
    TelemetryPublisher,
    TelemetrySchemaError,
    merge_histogram_dumps,
)
from agilerl_tpu_torch.observability.facade import RunTelemetry, init_run_telemetry
from agilerl_tpu_torch.observability.lineage import LineageTracker
from agilerl_tpu_torch.observability.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    warn_once,
)
from agilerl_tpu_torch.observability.slo import (
    AlertPolicy,
    Objective,
    SLOEvaluator,
    SLOSpec,
    aligned_buckets,
    attribute_scale_ups,
    load_slo_spec,
    registry_source,
    save_slo_spec,
    write_report,
)
from agilerl_tpu_torch.observability.timeline import (
    PhaseTimer,
    StepTimeline,
    device_memory_stats,
)
from agilerl_tpu_torch.observability.trace import (
    Span,
    SpanContext,
    Tracer,
    configure_tracer,
    current_span,
    export_perfetto,
    get_tracer,
    set_tracer,
    span_records,
    trace_tree,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "JsonlSink", "MemorySink", "NullSink", "read_jsonl",
    "StepTimeline", "PhaseTimer", "device_memory_stats",
    "LineageTracker",
    "RunTelemetry", "init_run_telemetry", "get_registry", "warn_once",
    "Tracer", "Span", "SpanContext", "get_tracer", "set_tracer",
    "configure_tracer", "current_span", "export_perfetto", "span_records",
    "trace_tree",
    "TelemetryPublisher", "TelemetryAggregator", "TelemetrySchemaError",
    "merge_histogram_dumps",
    "SLOSpec", "Objective", "AlertPolicy", "SLOEvaluator",
    "load_slo_spec", "save_slo_spec", "aligned_buckets",
    "attribute_scale_ups", "registry_source", "write_report",
]
