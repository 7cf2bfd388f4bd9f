"""Live telemetry plane: a scrapeable HTTP endpoint over the flight
recorder (copy of `ytpu.utils.telemetry`, over the port's registry,
recorder and profile).

`TelemetryServer` is a stdlib `http.server` on its OWN daemon thread, so
a serving process or a long replay is watchable live while the main
thread stays on the data path. Six endpoints:

- ``/metrics`` — Prometheus text exposition 0.0.4, straight from
  `MetricsRegistry.prometheus_text()`, plus any registered extra
  exposition blocks (`add_exposition`);
- ``/fleet`` — every registered fleet source (`add_fleet_source`)
  merged into ONE labeled exposition, ``replica="r0"`` per series;
- ``/snapshot`` — one JSON object merging `metrics.snapshot()`,
  `phases.snapshot()` and any registered *providers* (e.g. a device
  server's slot/queue view);
- ``/profile`` — the unified wall-time budget: one JSON report
  attributing the run's wall top-down (compile / device / staging /
  drain / finisher / net / host / idle fractions summing to 1) from
  `ytpu_torch.utils.profile`, or whatever windowed source the current
  run installed via `set_profile_source`;
- ``/healthz`` — liveness + the degradation surface: ``lane_ladder``
  and the age of the last device dispatch. A wedged device shows as a
  growing ``last_dispatch_age_s`` while this endpoint keeps answering
  (its thread never touches the data path). The port runs one integrate
  lane, its hand-written kernel, with no demotion ladder below it (the
  JAX package's Pallas → XLA → host ladder is outside the port), so
  ``lane_ladder`` is always ``{}``;
- ``/capacity`` — the phase recorder's per-program device-memory peak
  ledger (`phases.memory_report()`) plus every registered capacity
  provider (`add_capacity_provider`).

Design constraints honored:

- **zero data-path cost**: nothing here is called from the hot path;
  handlers read the same lock-protected registries the exporters always
  read.
- **no heavy imports**: `/healthz` reads the lane ladder only when
  `ytpu_torch.ops.integrate_kernel` is ALREADY loaded (`sys.modules`
  probe) — a host-only process scraping its telemetry never loads torch
  kernels.
- **ephemeral by default**: ``port=0`` binds any free port (the bound
  port is on `server.port` after `start()`), so parallel runs and tests
  never collide.

Attach points: ``DeviceSyncServer(telemetry_port=...)``, or
standalone::

    from ytpu_torch.utils.telemetry import TelemetryServer
    t = TelemetryServer(port=0)
    t.add_provider("pool", lambda: {"sessions": n_live})
    t.start()
    ...
    t.stop()
"""

from __future__ import annotations

import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from .metrics import _escape, _sanitize, metrics
from .phases import phases

__all__ = ["TelemetryServer"]

#: metrics the plane records about itself (scrape visibility is also an
#: observability surface — a dashboard that stops updating should be
#: distinguishable from a process that stopped serving)
_SCRAPES = metrics.counter("telemetry.scrapes", labelnames=("endpoint",))


class _Handler(BaseHTTPRequestHandler):
    server_version = "ytpu-telemetry/1"

    # set per TelemetryServer via the handler subclass it builds
    telemetry: "TelemetryServer"

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass

    def _reply(self, status: int, content_type: str, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib handler contract)
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                _SCRAPES.labels("metrics").inc()
                self._reply(
                    200,
                    "text/plain; version=0.0.4; charset=utf-8",
                    self.telemetry.metrics_text().encode("utf-8"),
                )
            elif path == "/fleet":
                _SCRAPES.labels("fleet").inc()
                self._reply(
                    200,
                    "text/plain; version=0.0.4; charset=utf-8",
                    self.telemetry.fleet_text().encode("utf-8"),
                )
            elif path == "/snapshot":
                _SCRAPES.labels("snapshot").inc()
                self._reply(
                    200,
                    "application/json",
                    json.dumps(self.telemetry.snapshot()).encode("utf-8"),
                )
            elif path == "/profile":
                _SCRAPES.labels("profile").inc()
                self._reply(
                    200,
                    "application/json",
                    json.dumps(self.telemetry.profile()).encode("utf-8"),
                )
            elif path == "/capacity":
                _SCRAPES.labels("capacity").inc()
                self._reply(
                    200,
                    "application/json",
                    json.dumps(self.telemetry.capacity()).encode("utf-8"),
                )
            elif path in ("/healthz", "/health"):
                _SCRAPES.labels("healthz").inc()
                self._reply(
                    200,
                    "application/json",
                    json.dumps(self.telemetry.healthz()).encode("utf-8"),
                )
            else:
                self._reply(404, "text/plain", b"not found\n")
        except BrokenPipeError:
            pass  # scraper went away mid-reply: its problem, not ours
        except Exception as e:  # a provider bug must not kill the plane
            try:
                self._reply(
                    500,
                    "application/json",
                    json.dumps(
                        {"error": f"{type(e).__name__}: {e}"[:300]}
                    ).encode("utf-8"),
                )
            except Exception:
                pass


class TelemetryServer:
    """Scrapeable telemetry endpoint on a daemon thread (see module
    docstring). ``providers`` are named zero-arg callables whose
    JSON-safe return values merge into ``/snapshot`` under their name —
    e.g. a device server's slot and queue view."""

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        providers: Optional[Dict[str, Callable[[], object]]] = None,
    ):
        self.host = host
        self.requested_port = port
        self.port: Optional[int] = None
        self._providers: Dict[str, Callable[[], object]] = dict(
            providers or {}
        )
        self._health_providers: Dict[str, Callable[[], object]] = {}
        #: `/fleet` sources: replica name -> zero-arg callable
        #: returning {metric name: value}; merged into one labeled
        #: exposition (`replica="<name>"`) by `fleet_text`
        self._fleet_sources: Dict[str, Callable[[], Dict[str, float]]] = {}
        #: extra Prometheus text appended to `/metrics`: name -> zero-arg
        #: callable returning exposition lines (e.g. a run's windowed
        #: `HistogramWindow` series as real histogram expositions)
        self._expositions: Dict[str, Callable[[], str]] = {}
        #: `/capacity` sections: name -> zero-arg callable
        #: (e.g. a HeadroomForecaster.report) merged into the capacity
        #: body next to the per-program memory ledger
        self._capacity_providers: Dict[str, Callable[[], object]] = {}
        #: `/profile` source: zero-arg callable returning the
        #: unified wall-time budget; defaults to the process-lifetime
        #: `profile_report()` window until a run installs its own
        self._profile_source: Optional[Callable[[], Dict]] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.time()

    # --- lifecycle -----------------------------------------------------------

    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the bound port."""
        if self._httpd is not None:
            return self.port  # idempotent
        outer = self

        class Handler(_Handler):
            telemetry = outer

        httpd = ThreadingHTTPServer((self.host, self.requested_port), Handler)
        httpd.daemon_threads = True
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._t0 = time.time()
        self._thread = threading.Thread(
            target=httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            name=f"ytpu-telemetry:{self.port}",
            daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "TelemetryServer":
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # --- payload assembly ----------------------------------------------------

    def add_provider(self, name: str, fn: Callable[[], object]) -> None:
        """Register (or replace) a named `/snapshot` section."""
        self._providers[name] = fn

    def remove_provider(self, name: str) -> None:
        self._providers.pop(name, None)
        self._health_providers.pop(name, None)

    def add_fleet_source(
        self, name: str, fn: Callable[[], Dict[str, float]]
    ) -> None:
        """Register (or replace) one replica's `/fleet` source: a
        zero-arg callable returning ``{metric name: numeric value}``
        (one per replica of a fleet)."""
        self._fleet_sources[name] = fn

    def remove_fleet_source(self, name: str) -> None:
        self._fleet_sources.pop(name, None)

    def add_exposition(self, name: str, fn: Callable[[], str]) -> None:
        """Register (or replace) a named block of extra Prometheus text
        appended to `/metrics` after the registry exposition."""
        self._expositions[name] = fn

    def set_profile_source(
        self, fn: Optional[Callable[[], Dict]]
    ) -> None:
        """Install (or, with None, clear) the `/profile` body source —
        a run installs its windowed `ProfileWindow.report` so the
        endpoint attributes THIS run's wall, not process lifetime."""
        self._profile_source = fn

    def profile(self) -> Dict:
        """The `/profile` JSON body: the unified wall-time budget from
        the installed source, defaulting to the process-lifetime window
        of `ytpu_torch.utils.profile`."""
        src = self._profile_source
        if src is not None:
            return src()
        from ytpu_torch.utils.profile import profile_report

        return profile_report()

    def add_capacity_provider(
        self, name: str, fn: Callable[[], object]
    ) -> None:
        """Register (or replace) a named `/capacity` section —
        typically a ``HeadroomForecaster.report``. Register the same
        callable with ``add_health_provider`` when its ``degraded``
        flag should also flip `/healthz`."""
        self._capacity_providers[name] = fn

    def capacity(self) -> Dict:
        """The `/capacity` JSON body: the per-program device-memory
        peak ledger (empty until a first sighting under
        ``YTPU_PHASES``) plus every registered capacity provider. A
        raising provider degrades to an error section — same contract
        as `/snapshot`."""
        out: Dict = {
            "time_unix": time.time(),
            "memory": phases.memory_report(),
        }
        for name, fn in list(self._capacity_providers.items()):
            try:
                out[name] = fn()
            except Exception as e:
                out[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
        return out

    def add_health_provider(self, name: str, fn: Callable[[], object]) -> None:
        """Register a named `/healthz` section: the section
        merges into the healthz body, and a dict section carrying a
        truthy ``"degraded"`` key flips the top-level ``status`` to
        ``"degraded"`` — how the replica mesh surfaces quarantined
        (divergent) tenants to a probe without the probe knowing the
        mesh exists."""
        self._health_providers[name] = fn

    def metrics_text(self) -> str:
        """The `/metrics` body: the registry exposition plus every
        registered extra exposition block (a raising block is skipped —
        the scrape must outlive its tenants' bugs)."""
        body = metrics.prometheus_text()
        for name in sorted(self._expositions):
            fn = self._expositions.get(name)
            if fn is None:
                continue
            try:
                extra = fn()
            except Exception:
                continue
            if extra:
                body += extra if extra.endswith("\n") else extra + "\n"
        return body

    def fleet_text(self) -> str:
        """The `/fleet` body: every fleet source's families
        merged into ONE exposition, each series labeled with its
        replica (``replica="r0"``).  Merge rules: families are unioned
        across sources and emitted sorted, one ``# TYPE <family> gauge``
        header per family with all replicas' series contiguous under it
        (valid Prometheus text exposition); metric names are sanitized
        exactly like the registry's (dots → underscores); a RAISING
        source degrades to a ``fleet_source_error{replica=...}`` series
        instead of failing the scrape."""
        fams: Dict[str, list] = {}
        errors = []
        for name in sorted(self._fleet_sources):
            fn = self._fleet_sources.get(name)
            if fn is None:
                continue
            try:
                vals = fn()
            except Exception:
                errors.append(name)
                continue
            for key in sorted(vals):
                fams.setdefault(_sanitize(key), []).append(
                    (name, float(vals[key]))
                )
        lines = []
        for fam in sorted(fams):
            lines.append(f"# TYPE {fam} gauge")
            for rep, v in fams[fam]:
                lines.append(f'{fam}{{replica="{_escape(rep)}"}} {v:.9g}')
        if errors:
            lines.append("# TYPE fleet_source_error gauge")
            for name in errors:
                lines.append(
                    f'fleet_source_error{{replica="{_escape(name)}"}} 1'
                )
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict:
        """The `/snapshot` JSON body: metrics + phases + providers. A
        raising provider degrades to an ``{"error": ...}`` section
        instead of failing the scrape — the plane outlives its
        tenants' bugs."""
        out: Dict = {
            "time_unix": time.time(),
            "metrics": metrics.snapshot(),
            "phases": phases.snapshot(),
        }
        for name, fn in list(self._providers.items()):
            try:
                out[name] = fn()
            except Exception as e:
                out[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
        return out

    def healthz(self) -> Dict:
        """The `/healthz` JSON body. Never imports the kernels: the lane
        ladder is read only when the kernel module is already loaded
        (the port has one lane, so its `lane_health()` is ``{}``)."""
        out: Dict = {
            "status": "ok",
            "uptime_s": round(time.time() - self._t0, 3),
            "lane_ladder": {},
        }
        ik = sys.modules.get("ytpu_torch.ops.integrate_kernel")
        if ik is not None:
            try:
                out["lane_ladder"] = ik.lane_health()
            except Exception as e:
                out["lane_ladder"] = {
                    "error": f"{type(e).__name__}: {e}"[:200]
                }
        # last-dispatch age: the freshest of the serving-loop flush
        # (sync.last_dispatch_unix) and the replay driver's chunk
        # dispatch (integrate.last_dispatch_unix); absent until either
        # path dispatched once. Read the two gauges directly — /healthz
        # is the highest-frequency probe and must stay O(1), not
        # O(registry) (gauge() get-or-creates, so reading before the
        # serving layer registers them just sees 0)
        last = 0.0
        for key in ("sync.last_dispatch_unix", "integrate.last_dispatch_unix"):
            last = max(last, float(metrics.gauge(key).value))
        if last > 0:
            out["last_dispatch_age_s"] = round(
                max(0.0, time.time() - last), 3
            )
        else:
            # the gauges default to 0 when NO dispatch ever happened —
            # an age computed from that epoch would read ~56 years.  Say
            # "never" explicitly and omit the age
            out["last_dispatch"] = "never"
        for name, fn in list(self._health_providers.items()):
            try:
                section = fn()
            except Exception as e:  # a provider bug must not kill the
                # probe — but it must not mask a degraded signal either:
                # a broken provider can no longer report, so degrade
                section = {
                    "error": f"{type(e).__name__}: {e}"[:200],
                    "degraded": True,
                }
            out[name] = section
            if isinstance(section, dict) and section.get("degraded"):
                out["status"] = "degraded"
        return out
