"""Workload harnesses that drive the port's stack the way production
traffic would: the port of ``agilerl_tpu/benchmarking/`` (the traffic
harness, ``traffic.py``)."""

from agilerl_tpu_torch.benchmarking.traffic import (
    ScenarioSpec,
    TrafficDriver,
    TrafficRequest,
    TrafficRunResult,
    generate_trace,
    load_trace,
    save_trace,
    scenario_suite,
    trace_header,
)

__all__ = [
    "ScenarioSpec", "TrafficRequest", "TrafficDriver", "TrafficRunResult",
    "generate_trace", "load_trace", "save_trace", "scenario_suite", "trace_header",
]
