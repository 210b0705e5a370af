"""Telemetry of the port: the metrics registry and distributed tracing
(``registry.py`` and ``trace.py``). The JAX package's other observability
modules (events, export, facade, lineage, slo, timeline) come with the
distribution slice."""

from agilerl_tpu_torch.observability.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    warn_once,
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
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry", "warn_once",
    "Tracer", "Span", "SpanContext", "get_tracer", "set_tracer",
    "configure_tracer", "current_span", "export_perfetto", "span_records",
    "trace_tree",
]
