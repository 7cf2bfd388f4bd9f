"""Admission control and backpressure for the serving path (copy of
`ytpu.serving.admission`; the two packages keep separate registries and
fault injectors).

The sync servers accept whatever arrives: a hot tenant can grow its
device queue without bound and a reconnect storm can outrun the flush
loop.  This module is the valve in front of `UpdatePipeline` /
`flush_device`:

- **bounded per-tenant queues** — an update whose tenant already has
  ``max_queue`` updates waiting for the device is not enqueued;
- **token-bucket rate limiting** — a global updates/s budget with a
  burst allowance (deterministic given an injected clock, so tests can
  assert exact decisions);
- **typed overload errors** — `QueueFull` / `RateLimited` (both
  `Overload`) carry the tenant, the reason, and a ``retry_after_s``
  hint, and surface to clients as protocol-level **Busy replies**
  (`protocol.busy_message`) instead of killed sessions.

Three policies decide what an overloaded update costs:

============  ===============================================================
``defer``     (default) reply Busy; the client re-sends after
              ``retry_after_s`` — no data loss, latency absorbs the spike
``drop``      discard the update silently (counted) — CRDT idempotence
              means a later full resync repairs it; cheapest, lossy
``shed``      kill the offending session (`net.sessions_dropped{reason=
              "shed"}`) — a reconnect resyncs via the state-vector
              handshake; sheds the *connection* cost, not just the update
============  ===============================================================

The controller is transport-agnostic: `SyncServer.receive_frames`
consults it per inbound update (queue depth comes from the server), and
`UpdatePipeline` calls `throttle()` from its staging producer so a bulk
replay's staging thread blocks instead of overrunning the device
(producer-side backpressure).

Fault site: ``admission.reject`` forces the next admit() to raise
`QueueFull`, to exercise the Busy path without saturating a queue.

Runtime retuning: `set_rate` / `set_queue_bound` (global) and
`set_tenant_rate` / `set_tenant_queue_bound` (per-tenant overrides) are
thread-safe and take effect on the NEXT admit/throttle call.  Every
change bumps ``admission.policy_changes``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ytpu_torch.utils import metrics
from ytpu_torch.utils.faults import faults

__all__ = [
    "Overload",
    "QueueFull",
    "RateLimited",
    "TokenBucket",
    "AdmissionController",
]

_ADMITTED = metrics.counter("admission.admitted")
_REJECTED = metrics.counter("admission.rejected", labelnames=("reason",))
_THROTTLE_WAITS = metrics.counter("admission.throttle_waits")
_THROTTLE_WAIT_HIST = metrics.histogram("admission.throttle_wait")
_POLICY_CHANGES = metrics.counter("admission.policy_changes")


class Overload(RuntimeError):
    """An update the admission layer refused.  ``retry_after_s`` is the
    hint a Busy reply carries back to the client."""

    reason = "overload"

    def __init__(self, tenant: str, detail: str, retry_after_s: float = 0.05):
        super().__init__(f"{self.reason} for tenant {tenant!r}: {detail}")
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class QueueFull(Overload):
    reason = "queue_full"


class RateLimited(Overload):
    reason = "rate_limited"


class TokenBucket:
    """Deterministic token bucket: ``rate`` tokens/s, ``burst`` capacity.

    `deficit(n)` returns 0.0 when ``n`` tokens were taken, else the
    seconds until they would be available (tokens are NOT taken on
    failure).  The clock is injectable so decisions are a pure function
    of (config, clock readings).  Thread-safe: one controller is shared
    between the server's accept loop and a pipeline's staging worker, so
    the read-modify-write on the token count takes a lock (same rule as
    every metric in `ytpu_torch.utils.metrics`)."""

    def __init__(
        self,
        rate: float,
        burst: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else rate)
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._last) * self.rate
        )
        self._last = now

    def deficit(self, n: float = 1.0) -> float:
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate

    def set_rate(self, rate: float, burst: Optional[float] = None) -> None:
        """Retune the bucket LIVE: refill at the old rate up
        to now, then switch — tokens already earned are kept (clamped to
        the new burst), so an in-flight throttler sees the new rate from
        its next clock reading, deterministically under an injected
        clock."""
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        with self._lock:
            self._refill_locked()
            self.rate = float(rate)
            self.burst = float(burst if burst is not None else rate)
            self._tokens = min(self._tokens, self.burst)

    def take_debt(self, n: float = 1.0) -> float:
        """Consume ``n`` unconditionally (tokens may go NEGATIVE — debt)
        and return the seconds the caller should sleep to amortize it.
        This is the producer-throttle primitive: waiting for ``n`` whole
        tokens can never finish when ``n > burst``, whereas debt keeps
        long-run throughput converging to ``rate`` for any chunk size."""
        with self._lock:
            self._refill_locked()
            self._tokens -= n
            return max(0.0, -self._tokens) / self.rate


class AdmissionController:
    """Per-tenant queue bounds + a global token bucket, one policy.

    ``max_queue``: per-tenant device-queue depth bound (None = unbounded).
    ``rate``/``burst``: global token bucket (None = no rate limit).
    ``policy``: "defer" | "drop" | "shed" (see module docstring).
    ``clock``/``sleep``: injectable for deterministic tests.
    """

    def __init__(
        self,
        max_queue: Optional[int] = 64,
        rate: Optional[float] = None,
        burst: Optional[float] = None,
        policy: str = "defer",
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if policy not in ("defer", "drop", "shed"):
            raise ValueError(f"policy must be defer/drop/shed, got {policy!r}")
        self.max_queue = max_queue
        self.policy = policy
        self.bucket = (
            TokenBucket(rate, burst, clock) if rate is not None else None
        )
        self._clock = clock
        self._sleep = sleep
        # per-tenant overrides: tenant -> bucket / queue bound,
        # consulted INSTEAD of the globals for that tenant.  Guarded by a
        # lock so a controller retune from an operator thread is atomic against the server's accept loop.
        self._lock = threading.Lock()
        self._tenant_buckets: dict = {}
        self._tenant_queue_bounds: dict = {}

    # --- runtime retuning --------------------------------------------------------

    def set_rate(
        self, rate: Optional[float], burst: Optional[float] = None
    ) -> None:
        """Retune the GLOBAL rate limit live; ``None`` removes it.  An
        existing bucket is retuned in place (earned tokens kept) so
        in-flight throttling sees the new rate without a reset."""
        with self._lock:
            if rate is None:
                self.bucket = None
            elif self.bucket is None:
                self.bucket = TokenBucket(rate, burst, self._clock)
            else:
                self.bucket.set_rate(rate, burst)
        _POLICY_CHANGES.inc()

    def set_queue_bound(self, max_queue: Optional[int]) -> None:
        """Retune the GLOBAL per-tenant queue bound live (None = unbounded)."""
        with self._lock:
            self.max_queue = max_queue
        _POLICY_CHANGES.inc()

    def set_tenant_rate(
        self, tenant: str, rate: Optional[float], burst: Optional[float] = None
    ) -> None:
        """Per-tenant rate override (None clears it back to the global)."""
        with self._lock:
            if rate is None:
                self._tenant_buckets.pop(tenant, None)
            elif tenant in self._tenant_buckets:
                self._tenant_buckets[tenant].set_rate(rate, burst)
            else:
                self._tenant_buckets[tenant] = TokenBucket(
                    rate, burst, self._clock
                )
        _POLICY_CHANGES.inc()

    def set_tenant_queue_bound(
        self, tenant: str, max_queue: Optional[int]
    ) -> None:
        """Per-tenant queue-bound override (None clears it)."""
        with self._lock:
            if max_queue is None:
                self._tenant_queue_bounds.pop(tenant, None)
            else:
                self._tenant_queue_bounds[tenant] = int(max_queue)
        _POLICY_CHANGES.inc()

    def policy_snapshot(self) -> dict:
        """The live knob values (a handy `/snapshot` surface for
        operators)."""
        with self._lock:
            return {
                "max_queue": self.max_queue,
                "rate": None if self.bucket is None else self.bucket.rate,
                "burst": None if self.bucket is None else self.bucket.burst,
                "tenant_rates": {
                    t: b.rate for t, b in sorted(self._tenant_buckets.items())
                },
                "tenant_queue_bounds": dict(
                    sorted(self._tenant_queue_bounds.items())
                ),
            }

    # --- server-side admission (per inbound update) ---------------------------

    def admit(self, tenant: str, queue_depth: int = 0, n: int = 1) -> None:
        """Admit ``n`` updates for ``tenant`` or raise a typed Overload.
        ``queue_depth`` is the tenant's CURRENT device-queue depth (the
        server passes it; depth shrinks via flush, so there is no
        release() to forget).

        Tracing: the decision emits an ``admission.admit``
        span carrying the ambient request trace context, so a refused
        frame's Busy reply is attributable in the Chrome trace next to
        its transport and dispatch spans."""
        from ytpu_torch.utils import tracer

        with tracer.span("admission.admit", depth=queue_depth, n=n):
            if faults.active and faults.fire(
                "admission.reject", tenant=tenant
            ):
                _REJECTED.labels("injected").inc()
                raise QueueFull(tenant, "injected admission fault")
            # per-tenant overrides REPLACE the global knob for that
            # tenant; read under the lock so a concurrent
            # retune is atomic
            with self._lock:
                max_queue = self._tenant_queue_bounds.get(
                    tenant, self.max_queue
                )
                bucket = self._tenant_buckets.get(tenant, self.bucket)
            if max_queue is not None and queue_depth + n > max_queue:
                _REJECTED.labels("queue_full").inc()
                raise QueueFull(
                    tenant,
                    f"queue depth {queue_depth} at bound {max_queue}",
                )
            if bucket is not None:
                wait = bucket.deficit(n)
                if wait > 0.0:
                    _REJECTED.labels("rate_limited").inc()
                    raise RateLimited(
                        tenant,
                        f"over rate {bucket.rate}/s",
                        retry_after_s=wait,
                    )
            _ADMITTED.inc(n)

    # --- producer-side backpressure (UpdatePipeline staging hook) -------------

    def throttle(self, n: int = 1) -> float:
        """Block the calling producer until ``n`` updates fit the rate
        budget; returns the seconds waited.  Queue bounds don't apply —
        a staging producer IS the queue; slowing it is the point.
        Debt-based (`TokenBucket.take_debt`), so a chunk larger than the
        burst sleeps proportionally instead of spinning forever."""
        if self.bucket is None:
            return 0.0
        wait = self.bucket.take_debt(n)
        if wait > 0.0:
            _THROTTLE_WAITS.inc()
            self._sleep(wait)
            _THROTTLE_WAIT_HIST.observe(wait)
        return wait

    # --- reply rendering ------------------------------------------------------

    @staticmethod
    def busy_reply(exc: Overload) -> bytes:
        """The encoded protocol-level Busy frame for one Overload."""
        from ytpu_torch.sync.protocol import busy_message

        return busy_message(exc.reason, exc.retry_after_s).encode_v1()
