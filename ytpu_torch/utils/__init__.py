"""Host-side utilities: labeled metrics and deterministic fault injection
(copies of `ytpu.utils.metrics` and `ytpu.utils.faults`)."""

from .faults import FaultError, FaultInjector, FaultSpec, faults
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, metrics

__all__ = [
    "Counter",
    "FaultError",
    "FaultInjector",
    "FaultSpec",
    "faults",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "metrics",
]
