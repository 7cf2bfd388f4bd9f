"""Serving subsystem: admission control and backpressure (the ported
part of `ytpu.serving`; its scenario, soak, canary and autopilot modules
are not ported)."""

from .admission import (
    AdmissionController,
    Overload,
    QueueFull,
    RateLimited,
    TokenBucket,
)

__all__ = [
    "AdmissionController",
    "Overload",
    "QueueFull",
    "RateLimited",
    "TokenBucket",
]
