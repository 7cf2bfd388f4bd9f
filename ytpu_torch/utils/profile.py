"""Unified wall-time attribution: one top-down time budget per run
(copy of `ytpu.utils.profile`, over the port's recorder and registry).

The flight recorder measures every stage separately — phase spans at the
kernels' call sites, the overlap engine's stage/stall gauges, the diff
pipeline's finisher timings, the serving loop's `sync.apply_update`
histogram. `ProfileWindow` folds them: it baselines the recorder and the
apply histogram at run start and, at report time, attributes the elapsed
wall into seven exclusive buckets:

- ``compile``   — first-sighting wall at the instrumented call sites
  (the sentinel's ``compile_s`` deltas: in the port, a kernel's first
  launch at a shape family);
- ``device``    — steady-state launches of the device programs (chunk
  programs, integrate/decode/compact, diff selection/pack);
- ``staging``   — host-side staging copies and ingest planning (the
  overlap engine's ``*.stage`` gauges, ``ingest.plan``);
- ``drain``     — device-to-host readout/checkpoint drains (``*.drain``,
  ``replay.readout``, ``replay.checkpoint``);
- ``finisher``  — the host/native diff finisher (``encode.finish``);
- ``net``       — serving-loop residual: `sync.apply_update` histogram
  wall not explained by the instrumented stages nested inside the apply
  path (framing, socket writes, queue hops);
- ``host``      — every other instrumented host stage.

``idle`` is what remains of the measured wall, and ``stall`` (the
overlap engine's consumer-blocked time) is reported informationally — a
stalled consumer overlaps device work, so charging it as busy would
double-count.  **Self-consistency invariant**: the eight
``profile_*_fraction`` values (seven buckets + idle) are computed against
``max(wall, busy)`` and sum to 1.0 (modulo float rounding); when measured
busy exceeds the wall (overlapped threads legitimately over-commit), the
excess is surfaced as ``overcommit_s`` instead of silently deflating a
bucket.

``rehearsal*``/``host.*`` stages are excluded, as in the JAX package
(its bench dry-run wrappers), and the classification rules are the JAX
package's, so every stage name falls in the same bucket in both.

Attach point: `TelemetryServer` serves ``profile_report()`` at
``/profile``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from ytpu_torch.utils.metrics import metrics
from ytpu_torch.utils.phases import PhaseRecorder, phases

__all__ = [
    "ProfileWindow",
    "classify_stage",
    "profile_report",
    "profile_fractions",
    "reset_global_window",
]

#: exclusive buckets, in report order (idle is derived, stall is info)
_BUCKETS = (
    "compile",
    "device",
    "staging",
    "drain",
    "finisher",
    "net",
    "host",
)

#: stage-name prefix → bucket; FIRST match wins, so the specific
#: encode/pipeline stage gauges are listed before the broad device
#: prefixes. Suffix rules (`.stall` / `.drain`) run before these.
_PREFIX_RULES = (
    ("staging", ("replay.stage", "encode.stage", "pipeline.stage",
                 "ingest.plan")),
    ("drain", ("replay.readout", "replay.checkpoint")),
    ("finisher", ("encode.finish",)),
    ("device", ("replay.chunk", "integrate.", "decode.", "compact.",
                "encode.select", "encode.pack", "encode.diff",
                "pipeline.decode", "ingest.")),
)


#: stages whose wall is ALREADY folded into another gauge — counting
#: them again would overcommit the budget for no information:
#: `DiffPipeline` adds its overlap-engine stage_s into `encode.select`,
#: and the `encode.pack` span runs nested inside that same timing
_DOUBLE_COUNTED = frozenset({"encode.stage", "encode.pack"})


def classify_stage(name: str) -> Optional[str]:
    """Bucket for one phases stage name; None = excluded (bench
    rehearsal wrappers, double-counted encode gauges), ``"stall"`` =
    informational only."""
    if name.startswith("rehearsal") or name.startswith("host."):
        return None
    if name in _DOUBLE_COUNTED:
        return None
    if name.endswith(".stall"):
        return "stall"
    if name.endswith(".drain"):
        return "drain"
    for bucket, prefixes in _PREFIX_RULES:
        for p in prefixes:
            if name.startswith(p):
                return bucket
    return "host"


def _apply_wall_s() -> float:
    """Cumulative `sync.apply_update` histogram wall in seconds (the
    serving loop's per-update host handling envelope). Reading the
    family fresh keeps this registry-reset-safe."""
    h = metrics.histogram("sync.apply_update")
    # mean_s * count round-trips through two properties; the raw
    # cumulative sum is what a window delta wants
    return float(h._sum_us) / 1e6


class ProfileWindow:
    """Baseline-and-delta fold of the flight recorder (module
    docstring). ``begin()`` re-baselines; ``report(wall_s=...)``
    attributes the window."""

    def __init__(self, recorder: Optional[PhaseRecorder] = None):
        self._rec = recorder if recorder is not None else phases
        self.begin()

    def _capture(self):
        snap = self._rec.snapshot()
        per_stage = {
            name: (d["compile_s"], d["execute_s"])
            for name, d in snap.items()
        }
        return per_stage, _apply_wall_s(), time.perf_counter()

    def begin(self) -> None:
        self._base, self._base_apply_s, self._t0 = self._capture()

    def report(self, wall_s: Optional[float] = None) -> Dict:
        """The top-down budget since `begin()`. ``wall_s`` overrides the
        window's own elapsed clock (a driver passes its measured run
        wall so the denominator matches its report)."""
        cur, apply_s, now = self._capture()
        wall = float(wall_s) if wall_s is not None else now - self._t0
        wall = max(wall, 0.0)
        seconds = {b: 0.0 for b in _BUCKETS}
        stall_s = 0.0
        for name, (comp, execu) in cur.items():
            base_comp, base_exec = self._base.get(name, (0.0, 0.0))
            d_comp = max(0.0, comp - base_comp)
            d_exec = max(0.0, execu - base_exec)
            bucket = classify_stage(name)
            if bucket is None:
                continue
            seconds["compile"] += d_comp
            if bucket == "stall":
                stall_s += d_exec
            else:
                seconds[bucket] += d_exec
        instrumented = sum(seconds.values())
        apply_delta = max(0.0, apply_s - self._base_apply_s)
        # the instrumented stages are (mostly) nested inside the apply
        # envelope; whatever the envelope measured beyond them is the
        # serving-loop residual — framing, sockets, queue hops
        seconds["net"] = max(0.0, apply_delta - instrumented)
        busy = sum(seconds.values())
        denom = max(wall, busy, 1e-9)
        idle = denom - busy
        out: Dict = {
            "wall_s": round(wall, 6),
            "measured_s": round(busy, 6),
            "overcommit_s": round(max(0.0, busy - wall), 6),
            "stall_s": round(stall_s, 6),
            "enabled": self._rec.enabled,
            "seconds": {
                **{b: round(v, 6) for b, v in seconds.items()},
                "idle": round(idle, 6),
            },
        }
        fractions_sum = 0.0
        for b in _BUCKETS + ("idle",):
            frac = (idle if b == "idle" else seconds[b]) / denom
            fractions_sum += frac
            out[f"profile_{b}_fraction"] = round(frac, 6)
        out["fractions_sum"] = round(fractions_sum, 6)
        return out


#: process-lifetime default window (the `/profile` endpoint's source
#: when nothing re-baselined it)
_GLOBAL: Optional[ProfileWindow] = None


def _global_window() -> ProfileWindow:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = ProfileWindow()
    return _GLOBAL


def reset_global_window() -> None:
    """Re-baseline the process-lifetime window (test isolation)."""
    global _GLOBAL
    _GLOBAL = None


def profile_report(
    window: Optional[ProfileWindow] = None, wall_s: Optional[float] = None
) -> Dict:
    """The default `/profile` body: the given (or process-lifetime)
    window's report."""
    return (window if window is not None else _global_window()).report(
        wall_s=wall_s
    )


def profile_fractions(window: Optional[ProfileWindow] = None) -> Dict[str, float]:
    """Flat ``{profile_*_fraction: value}`` — the `/fleet` per-replica
    merge shape (numeric-only)."""
    rep = profile_report(window)
    return {
        k: v for k, v in rep.items() if k.startswith("profile_")
    }
