"""Flight-recorder host tracing with Chrome-trace export (copy of
`ytpu.utils.trace`; the two packages keep separate tracers).

Spans wrap the host stages (decode, dispatch, encode, apply) and export
to the chrome://tracing / Perfetto JSON format. Device-side profiling
stays `torch.profiler`'s job: `trace_span` and its
``record_function`` annotations both use the host's wall clock.

Flight-recorder semantics: the event store is a BOUNDED ring
(drop-oldest, `max_events`), so a long-lived server can leave tracing on
and always holds the most recent window — the thing you want after a
crash. Two exit paths write it out:

- ``YTPU_TRACE=<path>`` in the environment enables the process-wide
  tracer at import and registers an atexit Chrome-trace dump to that
  path (``%p`` in the path expands to the pid — use it when parent and
  child processes share the variable). Processes that recorded nothing
  skip the write, so an instrumented child's dump is not clobbered by an
  idle parent.
- ``tracer.dump_on_error(error=e)`` — the hook `DeviceSyncServer`'s
  flush step calls from its exception path: appends an instant "error"
  event and writes immediately (atexit never runs when a process is
  killed by a timeout), so a failed device step leaves a replayable
  trace instead of a stderr tail. It re-raises nothing itself: the
  caller re-raises the original exception.

Disabled-path cost: `span()` returns a shared no-op context manager —
no allocation, no string formatting.
"""

from __future__ import annotations

import atexit
import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Optional

from .phases import NULL_SPAN as _NULL_SPAN  # shared no-op span singleton

__all__ = [
    "Tracer",
    "trace_span",
    "tracer",
    "trace_context",
    "current_trace",
    "current_trace_id",
    "new_trace_id",
    "resume_trace",
]

DEFAULT_MAX_EVENTS = 65536

# --- request trace context ---------------------------------------------------
# One ContextVar carries the ambient request identity (trace id + tenant/
# session args) through a request's host-side life: the transport handler
# opens a `trace_context()` per inbound frame, and every span/instant the
# request's processing emits — admission, apply, device dispatch, reply —
# automatically merges the context into its args, so a Chrome-trace dump
# correlates one frame across all layers without hand-threading ids.
# ContextVars propagate across awaits within an asyncio task (each
# connection handler is one task), but NOT into worker threads — thread
# hand-offs (the replay's staging slots, the device server's queues) carry
# the id explicitly instead.

_TRACE_CTX: "contextvars.ContextVar[Optional[dict]]" = contextvars.ContextVar(
    "ytpu_torch_trace_ctx", default=None
)
_TRACE_IDS = itertools.count(1)


def new_trace_id() -> str:
    """Process-unique request trace id (pid-scoped counter: cheap, and
    distinct across the processes sharing one YTPU_TRACE template)."""
    return f"t{os.getpid():x}-{next(_TRACE_IDS):x}"


def current_trace() -> Optional[dict]:
    """The ambient trace context fields, or None outside any request."""
    return _TRACE_CTX.get()


def current_trace_id() -> Optional[str]:
    """The ambient request's trace id, or None outside any request."""
    ctx = _TRACE_CTX.get()
    return None if ctx is None else ctx.get("trace")


class _TraceContext:
    __slots__ = ("_fields", "_token", "fields")

    def __init__(self, fields: dict):
        self._fields = fields

    def __enter__(self) -> dict:
        outer = _TRACE_CTX.get()
        merged = {**outer, **self._fields} if outer else self._fields
        self.fields = merged
        self._token = _TRACE_CTX.set(merged)
        return merged

    def __exit__(self, *exc):
        _TRACE_CTX.reset(self._token)
        return False


def trace_context(trace: Optional[str] = None, **fields):
    """Context manager installing a request trace context: ``trace`` is
    the request id (minted fresh when omitted); extra ``fields``
    (tenant=..., session=...) ride every span emitted inside. Nested
    contexts merge (inner keys win). When the tracer is disabled this
    returns the shared no-op context — zero allocation per frame."""
    if not tracer.enabled:
        return _NULL_SPAN
    if trace is None:
        trace = new_trace_id()
    return _TraceContext({"trace": trace, **fields})


def resume_trace(trace: str, origin: str = "", **fields):
    """Re-enter a trace context that crossed a process/replica boundary
    (fleet tracing): transports decoding a wire trace-context
    extension call this with the carried id + originating replica id, so
    every span the delivered frame's processing emits joins the SAME
    Chrome-trace id the sender started.  ``origin`` (when non-empty)
    rides the spans as an ``origin`` arg unless the caller overrides it."""
    if origin:
        fields.setdefault("origin", origin)
    return trace_context(trace=trace, **fields)


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_start")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        tr = self._tracer
        ev = {
            "name": self._name,
            "ph": "X",  # complete event
            "ts": (self._start - tr._t0) * 1e6,
            "dur": (end - self._start) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident() % 1_000_000,
        }
        if self._args:
            ev["args"] = self._args
        with tr._lock:
            tr._events.append(ev)  # deque(maxlen=...): drop-oldest
        return False


class Tracer:
    """Bounded-ring span recorder (drop-oldest at `max_events`)."""

    def __init__(
        self, enabled: bool = False, max_events: int = DEFAULT_MAX_EVENTS
    ):
        self.enabled = enabled
        self.max_events = max_events
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
        self._t0 = time.perf_counter()

    def __len__(self) -> int:
        return len(self._events)

    def span(self, name: str, **args):
        """Context manager recording one complete event; the disabled
        path returns a shared no-op (zero per-call allocation). An
        active `trace_context()` merges its fields (trace id, tenant,
        session) into the span args — explicit args win on collision."""
        if not self.enabled:
            return _NULL_SPAN
        ctx = _TRACE_CTX.get()
        if ctx is not None:
            args = {**ctx, **args}
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """One point-in-time marker event (phase transitions, errors).
        Merges the active `trace_context()` fields like `span`."""
        if not self.enabled:
            return
        ctx = _TRACE_CTX.get()
        if ctx is not None:
            args = {**ctx, **args}
        ev = {
            "name": name,
            "ph": "i",
            "s": "p",  # process-scoped instant
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident() % 1_000_000,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def export_chrome_trace(self, path: Optional[str] = None) -> str:
        with self._lock:
            events = list(self._events)
        payload = json.dumps({"traceEvents": events})
        if path:
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, path)  # atomic: a reader never sees a torn file
        return payload

    def dump_on_error(
        self, path: Optional[str] = None, error: Optional[BaseException] = None
    ) -> Optional[str]:
        """Crash hook: write the ring NOW (atexit may never run — a
        timeout may SIGKILL the process). Resolution order for the output
        path: explicit arg, then ``YTPU_TRACE`` (``%p`` → pid). Returns
        the written path, or None when no destination is configured.

        Writes even when the tracer was never enabled: an empty trace
        carrying the error instant still timestamps the failure."""
        if path is None:
            path = _env_trace_path()
        if path is None:
            return None
        was_enabled = self.enabled
        self.enabled = True
        try:
            self.instant(
                "error",
                type=type(error).__name__ if error is not None else "unknown",
                message=str(error)[:500] if error is not None else "",
            )
        finally:
            self.enabled = was_enabled
        try:
            self.export_chrome_trace(path)
        except OSError:
            # both call sites re-raise the ORIGINAL exception right after
            # this hook — a bad trace path must never replace it
            return None
        return path


tracer = Tracer()


def trace_span(name: str, **args):
    """Span on the process-wide tracer (no-op unless tracer.enable())."""
    return tracer.span(name, **args)


def _env_trace_path() -> Optional[str]:
    path = os.environ.get("YTPU_TRACE")
    if not path:
        return None
    return path.replace("%p", str(os.getpid()))


def _atexit_dump() -> None:
    path = _env_trace_path()
    if path and len(tracer):
        try:
            tracer.export_chrome_trace(path)
        except OSError:
            pass  # never let a bad trace path break process exit


if os.environ.get("YTPU_TRACE"):
    tracer.enable()
    atexit.register(_atexit_dump)
