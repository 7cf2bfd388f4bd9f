"""Deterministic fault injection for the host→device pipeline (copy of
`ytpu.utils.faults`; the two packages keep separate injectors).

The resilience machinery (checkpointed replay recovery, poison-update
quarantine, pipeline restarts) is only trustworthy if its failure paths
run under test — and real dispatch crashes and staging exceptions
cannot be produced on demand.  This module plants *named
injection sites* at the hot path's failure points; each site is a single
`faults.active` attribute check when nothing is armed, so the healthy
path pays one dict-is-empty test per site visit and allocates nothing.

Arming is deterministic and replayable: a site decision depends only on
the armed spec (its seed) and the site's *eligible pass counter*, never
on wall clock or object identity — the same `YTPU_FAULTS` string against
the same workload injects the same faults in the same places every run.

Grammar (`YTPU_FAULTS` env var, or `faults.configure(text)`):

    YTPU_FAULTS="site[:k=v[,k=v...]][;site2[:...]...]"

Reserved keys (all optional):

- ``n``     — how many times the spec fires (default 1; ``n=0`` = every
  eligible pass, unbounded);
- ``after`` — eligible passes skipped before the spec may fire
  (default 0: the first eligible pass fires);
- ``p``     — per-pass fire probability in [0, 1] (default: fire
  deterministically once ``after`` is exhausted);
- ``seed``  — RNG seed for ``p`` draws and payload corruption
  (default 0; the site name is folded in, so two sites armed with the
  same seed draw independent sequences).

Any other key is a free-form *site argument* (string or number) — e.g.
``mode=flip`` selects byte-flip corruption, ``prefix=replay`` restricts
``stage.raise`` to the replay's staging thread.  A site argument that names a *context* key the
call site passes (e.g. ``lane``) must match for the pass to be eligible.

Sites the port fires:

====================  =======================================================
``update.corrupt``    truncate/flip one staged update's wire bytes — fires
                      on both ingest lanes of the replay: per chunk in the
                      host-packed staging, and at the wire-table build of
                      the raw lane (same once-per-update stream order, so
                      an ``after=k`` spec poisons the same update either
                      way; the device decode flags the corrupt lane)
``replay.kill``       raise after a chunk dispatch with state treated as
                      lost (mid-replay worker death → checkpoint resume)
``stage.raise``       raise inside the overlap staging thread (args:
                      ``prefix`` = OverlapPipeline stage_prefix; covers
                      the raw memcpy staging and the packed staging alike
                      — the site lives in the shared engine's worker)
``admission.reject``  force the next admission decision to refuse (typed
                      `QueueFull` → protocol Busy reply / drop / shed per
                      the armed policy; args: ``tenant`` restricts to one
                      tenant)
``compile.retrace``   perturb the next instrumented call site's shape
                      signature with a nonce (args: ``program`` restricts
                      to one phases stage) — forces an attributable
                      retrace event, so chaos can prove the compile
                      sentinel and its budget scoring fire end to end
====================  =======================================================

Every fired injection increments the ``faults.injected`` counter (plus a
per-site ``faults.injected_by_site{site=...}`` child) so recovery tests
can assert the fault actually happened, not just that nothing crashed.
"""

from __future__ import annotations

import os
import random
import threading
import zlib
from contextlib import contextmanager
from typing import Dict, List, Optional

from ytpu_torch.utils.metrics import metrics

__all__ = ["FaultError", "FaultSpec", "FaultInjector", "faults"]

_INJECTED = metrics.counter("faults.injected")
_INJECTED_BY_SITE = metrics.counter(
    "faults.injected_by_site", labelnames=("site",)
)

class FaultError(RuntimeError):
    """An injected fault (never raised by real failures).  Recovery code
    treats it like the device/transport error its site simulates; code
    that must NOT mask injection (tests, the chaos smoke) can still
    `isinstance` it."""

    def __init__(self, site: str, spec: "FaultSpec"):
        super().__init__(f"injected fault at site {site!r}")
        self.site = site
        self.spec = spec


def _coerce(v: str):
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


class FaultSpec:
    """One armed fault: site + firing schedule + free-form site args."""

    __slots__ = ("site", "n", "after", "p", "seed", "args", "fired",
                 "passes", "_rng")

    def __init__(
        self,
        site: str,
        n: int = 1,
        after: int = 0,
        p: Optional[float] = None,
        seed: int = 0,
        **args,
    ):
        self.site = site
        self.n = int(n)
        self.after = int(after)
        self.p = None if p is None else float(p)
        self.seed = int(seed)
        self.args = args
        self.fired = 0
        self.passes = 0  # eligible passes seen (context-matched)
        # site name folded into the seed: two sites armed with one seed
        # draw independent, still fully deterministic sequences
        self._rng = random.Random(
            zlib.crc32(f"{self.seed}:{site}".encode()) & 0xFFFFFFFF
        )

    def _matches(self, ctx: Dict) -> bool:
        for k, v in ctx.items():
            want = self.args.get(k)
            if want is not None and str(want) != str(v):
                return False
        return True

    def _decide(self) -> bool:
        """Advance this spec's pass counter; True when it fires now."""
        self.passes += 1
        if self.n and self.fired >= self.n:
            return False
        if self.passes <= self.after:
            return False
        if self.p is not None and self._rng.random() >= self.p:
            return False
        self.fired += 1
        return True

    def __repr__(self):  # debugging / chaos-report aid
        return (
            f"FaultSpec({self.site!r}, n={self.n}, after={self.after}, "
            f"p={self.p}, fired={self.fired}, args={self.args})"
        )


class FaultInjector:
    """Process-wide registry of armed fault specs (thread-safe: staging
    threads and asyncio callbacks hit sites concurrently)."""

    def __init__(self):
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._lock = threading.Lock()
        self._suspended = 0
        self.active = False  # cheap hot-path gate, kept in sync below

    # ------------------------------------------------------------- arming

    def arm(self, site: str, **kw) -> FaultSpec:
        """Programmatically arm one spec; returns it (its `fired` counter
        is the per-spec assertion surface)."""
        spec = FaultSpec(site, **kw)
        with self._lock:
            self._specs.setdefault(site, []).append(spec)
            self.active = self._suspended == 0
        return spec

    def configure(self, text: Optional[str]) -> None:
        """Arm every spec in a `YTPU_FAULTS` grammar string (appends to
        whatever is already armed; empty/None is a no-op)."""
        if not text:
            return
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            site, _, argstr = part.partition(":")
            kw = {}
            for kv in filter(None, (s.strip() for s in argstr.split(","))):
                k, _, v = kv.partition("=")
                kw[k.strip()] = _coerce(v.strip()) if v else 1
            self.arm(site.strip(), **kw)

    def clear(self) -> None:
        with self._lock:
            self._specs.clear()
            self.active = False

    @contextmanager
    def suspended(self):
        """No site fires inside this block (the chaos smoke's clean-run
        baseline; armed specs keep their counters)."""
        with self._lock:
            self._suspended += 1
            self.active = False
        try:
            yield
        finally:
            with self._lock:
                self._suspended -= 1
                self.active = self._suspended == 0 and bool(self._specs)

    # -------------------------------------------------------------- sites

    def fire(self, site: str, **ctx) -> Optional[FaultSpec]:
        """One pass over `site`: returns the firing spec or None.  All
        context-matching specs advance their pass counters; the first
        that decides to fire wins the pass."""
        if not self.active:
            return None
        if site not in self._specs:
            # GIL-atomic dict read: sites with nothing armed stay
            # lock-free even while OTHER sites are (e.g. the per-update
            # update.corrupt pass during transport-only chaos)
            return None
        with self._lock:
            specs = self._specs.get(site)
            if not specs:
                return None
            hit = None
            for spec in specs:
                if not spec._matches(ctx):
                    continue
                if hit is None:
                    if spec._decide():
                        hit = spec
                else:
                    # the pass happened, but an earlier spec won it:
                    # advance the pass counter WITHOUT spending this
                    # spec's fire budget (`n`) — two specs armed on one
                    # site must inject on two separate passes
                    spec.passes += 1
        if hit is not None:
            _INJECTED.inc()
            _INJECTED_BY_SITE.labels(site).inc()
        return hit

    def maybe_raise(self, site: str, **ctx) -> None:
        spec = self.fire(site, **ctx)
        if spec is not None:
            raise FaultError(site, spec)

    def corrupt(self, site: str, payload: bytes, **ctx) -> bytes:
        """Pass one update's wire bytes through `site`; a firing spec
        returns a corrupted copy (mode=truncate cuts the payload in
        half — the decoder's FLAG_MALFORMED shape; mode=flip XORs one
        deterministic byte)."""
        spec = self.fire(site, **ctx)
        if spec is None:
            return payload
        mode = str(spec.args.get("mode", "truncate"))
        if mode == "flip" and payload:
            i = spec._rng.randrange(len(payload))
            return payload[:i] + bytes([payload[i] ^ 0xFF]) + payload[i + 1:]
        return payload[: max(1, len(payload) // 2)]

    def delay_s(self, site: str, **ctx) -> float:
        """Seconds the caller should stall (0.0 = not firing)."""
        spec = self.fire(site, **ctx)
        if spec is None:
            return 0.0
        return float(spec.args.get("ms", 50)) / 1e3


faults = FaultInjector()
faults.configure(os.environ.get("YTPU_FAULTS"))
