"""SLO scoring over the flight recorder's histograms (copy of
`ytpu.utils.slo`, over the port's `Histogram`).

The metrics registry is process-global and cumulative: a run that reads
`sync.apply_update.p99_s` directly would score every apply the process
EVER did, not the run it just drove.  `HistogramWindow` snapshots a
histogram's bucket counts at construction and answers quantiles over the
*delta* — the samples observed since the window opened — so one process
can score many runs back to back without resetting the registry
(resetting would orphan every cached metric object).

`slo_report` renders one window into a flat SLO dict: p50/p99 in
milliseconds, both **raw** and with a measured RTT/echo **floor
subtracted** (the `sync.apply_update` series reports raw wall time, which
over a network is dominated by transport latency the server cannot
control; the floor-subtracted number is the server-attributable
latency).  Subtraction clamps at zero — a quantile below the measured
floor means the floor estimate was noisy, not that the server served in
negative time.
"""

from __future__ import annotations

from typing import Dict, Optional

from ytpu_torch.utils.metrics import Histogram, _sanitize

__all__ = ["HistogramWindow", "slo_report", "window_prometheus_text"]


class HistogramWindow:
    """Delta view of a (possibly shared) histogram since construction."""

    def __init__(self, hist: Histogram):
        self._hist = hist
        with hist._vlock:
            self._base_counts = list(hist._counts)
            self._base_n = hist._n
            self._base_sum_us = hist._sum_us

    def _delta(self):
        h = self._hist
        with h._vlock:
            counts = [c - b for c, b in zip(h._counts, self._base_counts)]
            n = h._n - self._base_n
            sum_us = h._sum_us - self._base_sum_us
        return counts, n, sum_us

    @property
    def count(self) -> int:
        return self._delta()[1]

    @property
    def mean_s(self) -> float:
        counts, n, sum_us = self._delta()
        return (sum_us / n) / 1e6 if n else 0.0

    def quantile(self, q: float) -> float:
        """Approximate windowed quantile in seconds (same upper-bucket
        interpolation as `Histogram.quantile`, over the delta counts)."""
        counts, n, _ = self._delta()
        if n <= 0:
            return 0.0
        target = q * n
        acc = 0
        for b, c in enumerate(counts):
            acc += c
            if acc >= target:
                return Histogram.bucket_upper_s(b)
        return Histogram.bucket_upper_s(Histogram.N_BUCKETS - 1)

    @property
    def max_s(self) -> float:
        """Windowed maximum, at bucket resolution: the upper bound of
        the highest delta bucket holding ≥1 sample (the histogram stores
        bucket counts, not raw samples — a windowed exact max is not
        derivable from a cumulative max, so this reports the same
        upper-bucket bound the quantiles use). 0.0 for an empty
        window."""
        counts, n, _ = self._delta()
        if n <= 0:
            return 0.0
        last = max((b for b, c in enumerate(counts) if c), default=0)
        return Histogram.bucket_upper_s(last)


def window_prometheus_text(name: str, window: HistogramWindow) -> str:
    """Render one `HistogramWindow` as a REAL Prometheus histogram
    exposition: ``<name>_bucket{le=...}`` cumulative
    counts over the window's delta, ``<name>_bucket{le="+Inf"}``,
    ``<name>_sum`` (seconds) and ``<name>_count`` — the same bucket
    bounds and line shapes `MetricsRegistry.prometheus_text` emits for
    cumulative histograms, so an external scraper computes arbitrary
    windowed quantiles instead of trusting the p50/p99 gauges.  The
    name is sanitized like every registry family (dots → underscores).
    An empty window still emits the +Inf/_sum/_count triplet (a scraper
    must see the family exists)."""
    counts, n, sum_us = window._delta()
    sname = _sanitize(name)
    lines = [f"# TYPE {sname} histogram"]
    acc = 0
    last = max((b for b, c in enumerate(counts) if c), default=-1)
    for b in range(last + 1):
        acc += counts[b]
        le = Histogram.bucket_upper_s(b)
        lines.append(f'{sname}_bucket{{le="{le:.9g}"}} {acc}')
    lines.append(f'{sname}_bucket{{le="+Inf"}} {n}')
    lines.append(f"{sname}_sum {sum_us / 1e6:.9g}")
    lines.append(f"{sname}_count {n}")
    return "\n".join(lines) + "\n"


def slo_report(
    window: HistogramWindow,
    floor_s: float = 0.0,
    prefix: str = "",
    quantiles=(0.50, 0.99, 0.999),
) -> Dict[str, float]:
    """One histogram window → flat SLO dict (ms, 3 decimals).

    Keys: ``{prefix}p50_ms`` / ``{prefix}p99_ms`` / ``{prefix}p999_ms``
    / ``{prefix}max_ms`` (raw) and their ``_adj`` twins
    (RTT-floor-subtracted, clamped at 0) plus ``{prefix}count``.
    ``floor_s`` is the idle-echo round-trip floor the soak driver
    measured for THIS run.  p999/max exist because the p99 alone hides
    the extreme tail — a run can regress it 10× without moving p99 at
    these sample counts.
    """
    out: Dict[str, float] = {f"{prefix}count": window.count}
    for q in quantiles:
        # 0.999 must NOT collapse into "p99" (int(99.9) == 99): format
        # via %g and strip the dot — 0.5→p50, 0.99→p99, 0.999→p999
        name = "p" + f"{q * 100:g}".replace(".", "")
        raw = window.quantile(q)
        out[f"{prefix}{name}_ms"] = round(raw * 1e3, 3)
        out[f"{prefix}{name}_ms_adj"] = round(max(0.0, raw - floor_s) * 1e3, 3)
    mx = window.max_s
    out[f"{prefix}max_ms"] = round(mx * 1e3, 3)
    out[f"{prefix}max_ms_adj"] = round(max(0.0, mx - floor_s) * 1e3, 3)
    return out
