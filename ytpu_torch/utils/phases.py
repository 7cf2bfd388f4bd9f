"""Device-phase timers: first-launch-vs-steady-state attribution and
transfer bytes (copy of `ytpu.utils.phases`; the two packages keep
separate recorders).

The host-to-device pipeline's wall time hides three very different
costs: a kernel's first launch at a shape family, steady-state launches,
and host-device transfers. This recorder separates them at the kernels'
call sites (`ops/decode_kernel`, `ops/integrate_kernel`,
`ops/compaction`, `models/batch_doc`, `models/ingest`,
`models/pipeline`, `models/replay`) under the JAX package's stage names.

Attribution model: every instrumented call passes a hashable ``key``
describing the program's shape family (static arguments and operand
shapes). The FIRST call with an unseen (stage, key) is charged to
``compile_s``; later calls with the same key charge ``execute_s``.
``key=None`` marks a host-only stage with no first-launch phase. What
"compile" means here: the port builds its kernels ahead of time
(`ops/_build`), so a first sighting is a kernel's first launch at a
shape family — allocator growth for its outputs and scratch, and the
library's first load in the process — not an XLA compile. Launches are
asynchronous, so ``execute_s`` measures the host side of a call (plus
any blocking the callee already does): the recorder itself NEVER
synchronizes the device, so it is safe on the hot path.

Compile/retrace sentinel: beyond charging the time, every first
sighting is journaled as a *compile event* carrying the full shape
signature. A program's SECOND-or-later distinct signature is a
**retrace**: a new shape family on a warmed program. Call sites may name
the key's positions via ``axes=("state", "rows", ...)`` so the journal's
signature DELTA says *which axis changed* (an unnamed position reports
as ``argN``). Events surface three registry families (looked up fresh on
the rare first-sighting path, so a test-time ``metrics.reset()`` can't
orphan them): ``compile.events{program=}``, ``compile.retraces`` and
``compile.s_total``. Runs score retraces against a budget via
``compile_marker()`` / ``compile_report(since=)``, and
``compile_storm_provider`` turns a blown budget into a degraded
``/healthz`` (the ``compile.storm`` signal). A ``compile.retrace`` fault
site perturbs the signature on demand so chaos can prove the detector
fires end to end.

Device-memory attribution: the same first-sighting path can also
capture the program's memory kind split. A call site passes ``memory=``
a zero-arg thunk built with ``program_memory(...)`` from the launch's
tensors; the split is journaled INTO the compile event
(``event["memory"]``), surfaced as ``memory.program_bytes{program=,
kind=}`` gauges plus a ``memory.program_peak_bytes{program=}``
per-program ratchet, and rolled up by ``memory_report()``.

Disabled-path contract (the default): one attribute check, zero
allocation — call sites guard with ``if phases.enabled:`` before
building keys, and ``span()`` hands back a shared no-op context
manager. Enable via ``YTPU_PHASES=1`` or ``phases.enable()``.

Stage namespaces: ``replay.*`` is the replay's overlap lane (stage /
stall / overlap_ratio / inflight_depth / stage_bytes ...), ``encode.*``
the pipelined diff finisher (select / finish / d2h_bytes), ``decode.*``,
``integrate.*`` and ``compact.*`` the kernels' launches.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "PhaseRecorder",
    "phases",
    "NULL_SPAN",
    "compile_storm_provider",
    "program_memory",
]

#: journal ring bound — a run that compiles more programs than this is
#: itself a compile storm; the TAIL is what the sentinel reports on
_MAX_COMPILE_EVENTS = 4096


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Stage:
    __slots__ = (
        "calls",
        "compile_calls",
        "compile_s",
        "execute_s",
        "h2d_bytes",
        "d2h_bytes",
        "value",
    )

    def __init__(self):
        self.calls = 0
        self.compile_calls = 0
        self.compile_s = 0.0
        self.execute_s = 0.0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.value = None  # scalar gauge (overlap_ratio, in-flight depth)


def _sig_delta(prev, new, axes) -> List[Dict[str, str]]:
    """Element-wise diff of two signatures with axis-name attribution.
    Non-tuple keys compare as one-element tuples; a length change shows
    as an axis appearing/disappearing against ``<absent>``."""
    prev_t = prev if isinstance(prev, tuple) else (prev,)
    new_t = new if isinstance(new, tuple) else (new,)
    axes = tuple(axes or ())
    delta: List[Dict[str, str]] = []
    for i in range(max(len(prev_t), len(new_t))):
        a = prev_t[i] if i < len(prev_t) else "<absent>"
        b = new_t[i] if i < len(new_t) else "<absent>"
        if a != b:
            delta.append(
                {
                    "axis": axes[i] if i < len(axes) else f"arg{i}",
                    "prev": repr(a),
                    "new": repr(b),
                }
            )
    return delta


def _nbytes(a) -> int:
    """Bytes of every tensor or array in `a` (nested tuples, lists and
    NamedTuples walked; anything else counts 0). Reads shapes and dtypes
    only: no device access."""
    if hasattr(a, "element_size") and hasattr(a, "numel"):  # torch.Tensor
        return a.numel() * a.element_size()
    if hasattr(a, "nbytes") and hasattr(a, "dtype"):  # numpy
        return int(a.nbytes)
    if isinstance(a, (tuple, list)):
        return sum(_nbytes(x) for x in a)
    return 0


def program_memory(*args, outputs=None, aliased=(), scratch_bytes=0, **kwargs):
    """Build a zero-arg memory-capture thunk for ``span(memory=...)``.

    The twin of the JAX package's AOT ``memory_analysis()`` capture, in
    the same kind names, counted from the launch's own tensors:

    - ``argument_bytes`` — every tensor among ``args`` / ``kwargs``
      (nested tuples and NamedTuples walked), snapshotted EAGERLY when
      the thunk is built, since a call may replace its inputs;
    - ``output_bytes`` — the tensors ``outputs`` names (a zero-arg
      callable read when the thunk runs, at span exit, or the tensors
      themselves), tensors written in place included;
    - ``alias_bytes`` — the tensors in ``aliased``: arguments the
      launch writes in place, so they count as argument and output;
    - ``temp_bytes`` — ``scratch_bytes``, the device scratch the
      wrapper allocates for the launch (an int, or a zero-arg callable);
    - ``generated_code_bytes`` — 0: a kernel's machine code lives in its
      shared library (``ytpu_torch/_build``), loaded once per process,
      not per program.

    Only shapes and dtypes are read: the thunk never synchronizes the
    device and never resets the allocator's peak counters."""
    arg_bytes = _nbytes(args) + _nbytes(tuple(kwargs.values()))
    alias_bytes = _nbytes(aliased)

    def thunk():
        out = outputs() if callable(outputs) else outputs
        temp = scratch_bytes() if callable(scratch_bytes) else scratch_bytes
        return {
            "temp_bytes": int(temp),
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(_nbytes(out)),
            "alias_bytes": int(alias_bytes),
            "generated_code_bytes": 0,
        }

    return thunk

class _PhaseSpan:
    __slots__ = ("_rec", "_stage", "_key", "_axes", "_start", "_memory")

    def __init__(
        self, rec: "PhaseRecorder", stage: str, key, axes=None, memory=None
    ):
        self._rec = rec
        self._stage = stage
        self._key = key
        self._axes = axes
        self._memory = memory

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._start
        rec = self._rec
        event = None
        with rec._lock:
            st = rec._stages.get(self._stage)
            if st is None:
                st = rec._stages[self._stage] = _Stage()
            st.calls += 1
            if self._key is not None and (
                (self._stage, self._key) not in rec._seen
            ):
                rec._seen.add((self._stage, self._key))
                st.compile_calls += 1
                st.compile_s += dt
                event = rec._record_compile_locked(
                    self._stage, self._key, self._axes, dt
                )
            else:
                st.execute_s += dt
        if event is not None:
            rec._emit_compile_metrics(event)
            if self._memory is not None:
                rec._record_memory(self._stage, event, self._memory)
        return False


class PhaseRecorder:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._stages: Dict[str, _Stage] = {}
        self._seen: set = set()
        self._lock = threading.Lock()
        # ---- compile/retrace sentinel state ----
        #: per program (stage): signatures in first-sighting order
        self._signatures: Dict[str, List] = {}
        #: per program: last axes names supplied by its call site
        self._axes: Dict[str, Tuple[str, ...]] = {}
        #: compile-event journal (bounded ring; see compile_events)
        self._events: List[Dict] = []
        self._event_seq = 0
        # ---- device-memory attribution ----
        #: per program: peak resident bytes + the signature that set it
        self._memory_peaks: Dict[str, Dict] = {}

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._stages.clear()
            self._seen.clear()
            self._signatures.clear()
            self._axes.clear()
            self._events.clear()
            self._event_seq = 0
            self._memory_peaks.clear()

    # --- compile/retrace sentinel ---------------------------------------------

    def _record_compile_locked(self, stage: str, key, axes, dt: float):
        """Journal one first-sighting (caller holds the lock). The
        SECOND-or-later signature for a program is a retrace; its delta
        names the axis that changed vs the previous signature."""
        sigs = self._signatures.setdefault(stage, [])
        if axes:
            self._axes[stage] = tuple(axes)
        retrace = bool(sigs)
        delta = (
            _sig_delta(sigs[-1], key, self._axes.get(stage))
            if retrace
            else []
        )
        sigs.append(key)
        self._event_seq += 1
        event = {
            "seq": self._event_seq,
            "program": stage,
            "compile_s": round(dt, 6),
            "signature": repr(key),
            "retrace": retrace,
            "delta": delta,
        }
        self._events.append(event)
        if len(self._events) > _MAX_COMPILE_EVENTS:
            del self._events[: len(self._events) - _MAX_COMPILE_EVENTS]
        return event

    @staticmethod
    def _emit_compile_metrics(event: Dict) -> None:
        """Registry families for the sentinel — looked up fresh (the
        compile path is rare, and cached family objects would be
        orphaned by a test-time ``metrics.reset()``)."""
        try:
            from ytpu_torch.utils.metrics import metrics
        except Exception:  # pragma: no cover - import cycles in teardown
            return
        metrics.counter("compile.events", labelnames=("program",)).labels(
            event["program"]
        ).inc()
        metrics.gauge("compile.s_total").inc(event["compile_s"])
        if event["retrace"]:
            metrics.counter("compile.retraces").inc()

    def _fault_key(self, stage: str, key):
        """``compile.retrace`` fault site: a firing spec perturbs the
        signature with a nonce, forcing an attributable retrace — how
        chaos proves the sentinel catches real recompiles."""
        try:
            from ytpu_torch.utils.faults import faults
        except Exception:  # pragma: no cover
            return key
        if not faults.active:
            return key
        spec = faults.fire("compile.retrace", program=stage)
        if spec is None:
            return key
        nonce = ("__fault__", spec.fired)
        return key + (nonce,) if isinstance(key, tuple) else (key, nonce)

    # --- device-memory attribution ---------------------------------------------

    def _record_memory(self, stage: str, event: Dict, thunk) -> None:
        """Capture one program's memory analysis on its first-sighting
        path (caller just emitted the compile event — the lock is NOT
        held). A thunk that raises means nothing can be reported: skip
        silently, the time attribution already happened.

        ``resident_bytes`` is the device footprint while the program
        runs: arguments + outputs − aliased (tensors written in place
        count in both) + temps. Generated code is charged separately:
        it is not per-invocation."""
        try:
            kinds = thunk()
        except Exception:
            return
        if not kinds:
            return
        kinds = dict(kinds)
        resident = (
            kinds.get("argument_bytes", 0)
            + kinds.get("output_bytes", 0)
            - kinds.get("alias_bytes", 0)
            + kinds.get("temp_bytes", 0)
        )
        kinds["resident_bytes"] = int(resident)
        peak = 0
        with self._lock:
            event["memory"] = kinds
            rec = self._memory_peaks.get(stage)
            if rec is None or resident > rec["peak_bytes"]:
                rec = self._memory_peaks[stage] = {
                    "peak_bytes": int(resident),
                    "signature": event["signature"],
                    "kinds": kinds,
                }
            peak = rec["peak_bytes"]
        self._emit_memory_metrics(stage, kinds, peak)

    @staticmethod
    def _emit_memory_metrics(stage: str, kinds: Dict, peak: int) -> None:
        """Registry families for memory attribution — fresh lookups for
        the same reset-safety reason as ``_emit_compile_metrics``."""
        try:
            from ytpu_torch.utils.metrics import metrics
        except Exception:  # pragma: no cover - import cycles in teardown
            return
        fam = metrics.gauge(
            "memory.program_bytes", labelnames=("program", "kind")
        )
        for kind, v in kinds.items():
            fam.labels(stage, kind).set(float(v))
        metrics.gauge(
            "memory.program_peak_bytes", labelnames=("program",)
        ).labels(stage).set(float(peak))

    def memory_report(self) -> Dict:
        """Per-program peak-resident ledger + the overall peak program:
        ``{"programs": {stage: {peak_bytes, signature, kinds}},
        "peak_bytes": int, "peak_program": str|None}``. Peaks are
        keyed by shape family — the signature names which shape set
        the high-water mark."""
        with self._lock:
            programs = {
                k: {
                    "peak_bytes": v["peak_bytes"],
                    "signature": v["signature"],
                    "kinds": dict(v["kinds"]),
                }
                for k, v in self._memory_peaks.items()
            }
        peak_program = None
        peak_bytes = 0
        for name, rec in programs.items():
            if rec["peak_bytes"] > peak_bytes:
                peak_bytes = rec["peak_bytes"]
                peak_program = name
        return {
            "programs": programs,
            "peak_bytes": peak_bytes,
            "peak_program": peak_program,
        }

    def compile_marker(self) -> int:
        """Opaque high-water mark for ``compile_report(since=...)`` —
        take one after warmup; events at or before it are 'expected
        cold compiles', anything after is scored."""
        with self._lock:
            return self._event_seq

    def compile_events(self, since: int = 0) -> List[Dict]:
        """Journal entries with seq > ``since`` (copies)."""
        with self._lock:
            return [dict(e) for e in self._events if e["seq"] > since]

    def compile_report(self, since: int = 0) -> Dict:
        """Sentinel rollup since a marker: total events, retrace count,
        compile seconds, per-program event counts, and the retrace
        journal (each entry's ``delta`` names the changed axes)."""
        evs = self.compile_events(since)
        programs: Dict[str, int] = {}
        retraces = 0
        s_total = 0.0
        for e in evs:
            programs[e["program"]] = programs.get(e["program"], 0) + 1
            s_total += e["compile_s"]
            if e["retrace"]:
                retraces += 1
        return {
            "events": len(evs),
            "retraces": retraces,
            "s_total": round(s_total, 6),
            "programs": programs,
            "journal": [e for e in evs if e["retrace"]],
        }

    # --- timers --------------------------------------------------------------

    def span(self, stage: str, key=None, axes=None, memory=None):
        """Time one call of `stage`. `key` identifies the program's shape
        family (first sighting = "compile"); None = host-only stage.
        ``axes`` optionally names the key's positions for retrace
        attribution (e.g. ``("state", "rows", "scan_plan")``).
        ``memory`` optionally passes a ``program_memory(...)`` thunk,
        invoked ONLY on the first-sighting path to journal the
        program's device-memory kind split."""
        if not self.enabled:
            return NULL_SPAN
        if key is not None:
            key = self._fault_key(stage, key)
        return _PhaseSpan(self, stage, key, axes, memory)

    def transfer(
        self, stage: str, nbytes: int, direction: str = "h2d"
    ) -> None:
        """Count host↔device bytes against `stage` (`direction` is
        "h2d" or "d2h"). No-op (one attribute check) when disabled."""
        if not self.enabled:
            return
        with self._lock:
            st = self._stages.get(stage)
            if st is None:
                st = self._stages[stage] = _Stage()
            if direction == "h2d":
                st.h2d_bytes += int(nbytes)
            else:
                st.d2h_bytes += int(nbytes)

    def add_time(self, stage: str, seconds: float, calls: int = 1) -> None:
        """Accumulate already-measured wall time against a host-only
        stage. The overlap engine times its staging/stall work with bare
        perf_counter reads on the worker/main threads (a span object per
        chunk would allocate on the hot path) and folds the totals in
        here at loop exit."""
        if not self.enabled:
            return
        with self._lock:
            st = self._stages.get(stage)
            if st is None:
                st = self._stages[stage] = _Stage()
            st.calls += int(calls)
            st.execute_s += float(seconds)

    def set_value(self, stage: str, value: float) -> None:
        """Record a scalar gauge under `stage` (snapshot key "value") —
        e.g. ``replay.overlap_ratio``, ``replay.inflight_depth``."""
        if not self.enabled:
            return
        with self._lock:
            st = self._stages.get(stage)
            if st is None:
                st = self._stages[stage] = _Stage()
            st.value = float(value)

    def add_value(self, stage: str, delta: float) -> None:
        """Accumulate a scalar gauge (snapshot key "value") — e.g.
        ``replay.stage_bytes``, the raw-ingest lane's total staged
        payload bytes. Unlike `transfer` this counts HOST-side copy
        volume (staging is a host memcpy, not an h2d transfer — the
        chunk programs count their own h2d bytes), and unlike
        `set_value` it survives multi-run accumulation (a checkpoint
        resume re-enters the overlap loop)."""
        if not self.enabled:
            return
        with self._lock:
            st = self._stages.get(stage)
            if st is None:
                st = self._stages[stage] = _Stage()
            st.value = (st.value or 0.0) + float(delta)

    def set_max(self, stage: str, value: float) -> None:
        """Ratchet a scalar gauge upward (high-water depth tracking)."""
        if not self.enabled:
            return
        with self._lock:
            st = self._stages.get(stage)
            if st is None:
                st = self._stages[stage] = _Stage()
            st.value = value if st.value is None else max(st.value, value)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-stage breakdown: calls / compile_calls / compile_s /
        execute_s / h2d_bytes / d2h_bytes / transfer_bytes (sum)."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for name, st in self._stages.items():
                out[name] = {
                    "calls": st.calls,
                    "compile_calls": st.compile_calls,
                    "compile_s": round(st.compile_s, 6),
                    "execute_s": round(st.execute_s, 6),
                    "h2d_bytes": st.h2d_bytes,
                    "d2h_bytes": st.d2h_bytes,
                    "transfer_bytes": st.h2d_bytes + st.d2h_bytes,
                }
                if st.value is not None:
                    out[name]["value"] = round(st.value, 6)
        return out


def compile_storm_provider(
    budget: Optional[int] = 0,
    marker: int = 0,
    recorder: Optional[PhaseRecorder] = None,
):
    """Health-provider factory for ``TelemetryServer.add_health_provider``
    (register under the name ``"compile"``): reports retraces since
    ``marker`` and flips ``degraded``/``storm`` once they exceed
    ``budget`` (None = report-only, never degrades). The section also
    carries the LAST retrace's signature delta so a probe sees *which
    axis changed* without walking the journal."""

    def provider() -> Dict:
        rec = recorder if recorder is not None else phases
        rep = rec.compile_report(since=marker)
        storm = budget is not None and rep["retraces"] > budget
        last = rep["journal"][-1] if rep["journal"] else None
        return {
            "retraces": rep["retraces"],
            "budget": budget,
            "compile_s": rep["s_total"],
            "storm": storm,
            "degraded": storm,
            "last_retrace": (
                {
                    "program": last["program"],
                    "delta": last["delta"],
                }
                if last
                else None
            ),
        }

    return provider


phases = PhaseRecorder(enabled=bool(os.environ.get("YTPU_PHASES")))
