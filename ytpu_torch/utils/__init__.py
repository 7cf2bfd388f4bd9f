"""Host-side utilities: metrics, tracing, phase timers, SLO windows, the
wall-time profile, the telemetry plane and fault injection (copies of
`ytpu.utils`' modules; the two packages keep separate registries,
recorders, tracers and injectors)."""

from .faults import FaultError, FaultInjector, FaultSpec, faults
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, metrics
from .phases import PhaseRecorder, phases
from .slo import HistogramWindow, slo_report
from .telemetry import TelemetryServer
from .trace import (
    Tracer,
    current_trace,
    current_trace_id,
    new_trace_id,
    trace_context,
    trace_span,
    tracer,
)

__all__ = [
    "Counter",
    "current_trace",
    "current_trace_id",
    "FaultError",
    "FaultInjector",
    "FaultSpec",
    "faults",
    "Gauge",
    "Histogram",
    "HistogramWindow",
    "MetricsRegistry",
    "metrics",
    "new_trace_id",
    "PhaseRecorder",
    "phases",
    "slo_report",
    "TelemetryServer",
    "trace_context",
    "Tracer",
    "trace_span",
    "tracer",
]
