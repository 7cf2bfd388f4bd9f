"""The port's telemetry plane, SLO windows and wall-time profile against
the JAX package's, on the CPU.

`HistogramWindow` / `slo_report` / `window_prometheus_text` over the same
seeded samples; `ProfileWindow` over the same recorder calls (one fake
clock each); then a `TelemetryServer` of each package on port 0, each
reading a fresh registry and recorder that took the same operations:
every endpoint answers with the same body (``/metrics`` and ``/fleet``
text byte for byte, the JSON endpoints key for key, wall clocks aside).
Last, `DeviceSyncServer(telemetry_port=0)`: the server's ``/snapshot``
section equals the JAX package's, and ``/healthz`` reports
``last_dispatch: "never"`` until the first flush and an age after it.
"""

import importlib
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_obs import FakeClock, swap_module_globals

PKGS = ("ytpu", "ytpu_torch")


def _mods(pkg):
    return {m: importlib.import_module(f"{pkg}.utils.{m}")
            for m in ("metrics", "phases", "profile", "slo", "telemetry")}


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def test_slo_window_matches_ytpu():
    rng = np.random.default_rng(13)
    before, during = rng.lognormal(-8, 1.5, 200), rng.lognormal(-7, 2.0, 500)
    outs = []
    for pkg in PKGS:
        m = _mods(pkg)
        h = m["metrics"].Histogram("sync.apply_update")
        for s in before:
            h.observe(float(s))
        w = m["slo"].HistogramWindow(h)
        empty = (m["slo"].window_prometheus_text("sync.apply_update", w), m["slo"].slo_report(w))
        for s in during:
            h.observe(float(s))
        outs.append((empty, w.count, round(w.mean_s, 12), [w.quantile(q) for q in (0.5, 0.9, 0.99, 0.999)],
                     w.max_s, m["slo"].window_prometheus_text("sync.apply_update", w),
                     m["slo"].slo_report(w, floor_s=0.0003, prefix="apply_")))
    assert outs[1] == outs[0]
    assert outs[1][1] == len(during)


def _profile_ops(rec, seed=19):
    rng = np.random.default_rng(seed)
    names = ["replay.chunk_raw", "replay.stage", "replay.stall", "encode.finish", "ingest.plan",
             "replay.readout", "sync.dispatch", "encode.pack", "host.replay", "decode.v1"]
    for _ in range(60):
        n = names[int(rng.integers(len(names)))]
        if rng.integers(2):
            rec.add_time(n, float(rng.integers(1, 500)) / 1e4, int(rng.integers(1, 3)))
        else:
            with rec.span(n, key=None if rng.integers(2) else (int(rng.integers(3)),)):
                pass


def test_profile_window_matches_ytpu(monkeypatch):
    reports = []
    for pkg in PKGS:
        m = _mods(pkg)
        monkeypatch.setattr(m["phases"], "time", FakeClock())
        monkeypatch.setattr(m["profile"], "time", FakeClock(step=0.5))
        rec = m["phases"].PhaseRecorder(enabled=True)
        _profile_ops(rec, seed=2)  # before the window: not attributed
        win = m["profile"].ProfileWindow(recorder=rec)
        _profile_ops(rec)
        reports.append((win.report(wall_s=0.8), win.report(wall_s=0.01), win.report(),
                        m["profile"].profile_fractions(win)))
    assert reports[1] == reports[0]
    for rep in reports[1][:3]:
        assert abs(rep["fractions_sum"] - 1.0) < 1e-6
    assert reports[1][1]["overcommit_s"] > 0


def _registry_ops(reg, rng):
    for i in range(40):
        k = int(rng.integers(4))
        if k == 0:
            reg.counter("sync.updates_applied").inc(int(rng.integers(1, 5)))
        elif k == 1:
            reg.counter("sync.tenant_updates_applied", labelnames=("tenant",)).labels(
                f"t{int(rng.integers(3))}").inc()
        elif k == 2:
            reg.gauge("sync.device_queue_depth").set(float(rng.integers(50)))
        else:
            reg.histogram("sync.apply_update").observe(float(rng.lognormal(-8, 1)))
    reg.gauge("sync.last_dispatch_unix").set(0.0)


@pytest.fixture
def planes(monkeypatch):
    """A started `TelemetryServer` per package, each reading a fresh
    registry and recorder (swapped in for the process-wide ones, which
    are left as they were) that took the same operations."""
    out = []
    for pkg in PKGS:
        m = _mods(pkg)
        reg, rec = m["metrics"].MetricsRegistry(), m["phases"].PhaseRecorder(enabled=True)
        swap_module_globals(monkeypatch, pkg, m["metrics"].metrics, reg)
        swap_module_globals(monkeypatch, pkg, m["phases"].phases, rec)
        monkeypatch.setattr(m["phases"], "time", FakeClock())
        _registry_ops(reg, np.random.default_rng(31))
        _profile_ops(rec)
        with rec.span("decode.v1", key=(8,), memory=lambda: {"temp_bytes": 64, "argument_bytes": 256}):
            pass
        win = m["profile"].ProfileWindow(recorder=rec)
        t = m["telemetry"].TelemetryServer(port=0)
        t.add_provider("pool", lambda: {"sessions": 3})
        t.add_provider("broken", lambda: 1 / 0)
        t.add_fleet_source("r0", lambda: {"sync.updates_applied": 5, "net.frames_in": 2.5})
        t.add_fleet_source("r1", lambda: {"sync.updates_applied": 7})
        t.add_fleet_source("down", lambda: {}[0])
        t.add_exposition("extra", lambda: "# TYPE extra_series gauge\nextra_series 1")
        t.add_capacity_provider("forecast", lambda: {"degraded": False, "headroom": 0.5})
        t.add_health_provider("compile", m["phases"].compile_storm_provider(budget=None, recorder=rec))
        t.set_profile_source(lambda w=win: w.report(wall_s=2.0))
        t.start()
        out.append((t, reg))
    yield out
    for t, _ in out:
        t.stop()


def test_endpoints_match_ytpu(planes):
    (yt, yreg), (tt, treg) = planes
    assert tt.port > 0 and tt.port != yt.port
    bodies = {}
    for ep in ("metrics", "fleet", "snapshot", "profile", "healthz", "health", "capacity"):
        (ys, yct, yb), (ts, tct, tb) = _get(f"{yt.url}/{ep}"), _get(f"{tt.url}/{ep}")
        assert (ts, tct) == (ys, yct) == (200, tct)
        if ep in ("metrics", "fleet"):
            assert tb == yb, ep
        else:
            yj, tj = json.loads(yb), json.loads(tb)
            for j in (yj, tj):
                j.pop("time_unix", None)
                j.pop("uptime_s", None)
                j.pop("lane_ladder", None)
            assert tj == yj, ep
            bodies[ep] = tj
    assert 'replica="r1"' in _get(f"{tt.url}/fleet")[2] and "fleet_source_error" in _get(f"{tt.url}/fleet")[2]
    assert bodies["healthz"]["last_dispatch"] == "never" and "last_dispatch_age_s" not in bodies["healthz"]
    assert bodies["snapshot"]["broken"]["error"].startswith("ZeroDivisionError")
    assert abs(bodies["profile"]["fractions_sum"] - 1.0) < 1e-6
    assert bodies["capacity"]["memory"]["peak_program"] == "decode.v1"
    assert json.loads(_get(f"{tt.url}/healthz")[2])["lane_ladder"] == {}
    for t in (yt, tt):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{t.url}/nope")
        assert e.value.code == 404
    # the dispatch gauges move /healthz from "never" to an age
    for reg in (yreg, treg):
        reg.gauge("integrate.last_dispatch_unix").set(time.time() - 5.0)
    ages = [json.loads(_get(f"{t.url}/healthz")[2]) for t in (yt, tt)]
    for h in ages:
        assert "last_dispatch" not in h and 4.0 <= h["last_dispatch_age_s"] < 60.0
    # the plane counts its own scrapes in each package's process-wide registry
    scrapes = importlib.import_module("ytpu_torch.utils.telemetry")._SCRAPES
    assert scrapes.labels("healthz").value >= 3


def test_device_server_telemetry_matches_ytpu():
    """The server's ``/snapshot`` section equals the JAX package's for the
    same tenants; the port's ``/healthz`` turns from "never" to an age at
    its first flush."""
    from ytpu.core import Doc as YDoc
    from ytpu.sync.device_server import DeviceSyncServer as YServer
    from ytpu_torch.core.doc import Doc as TDoc
    from ytpu_torch.sync.device_server import DeviceSyncServer as TServer
    from ytpu_torch.sync.protocol import Message, SyncMessage

    servers = [YServer(n_docs=2, capacity=64, telemetry_port=0, doc_factory=lambda n: YDoc(client_id=9)),
               TServer(n_docs=2, capacity=64, telemetry_port=0, device="cpu",
                       doc_factory=lambda n: TDoc(client_id=9))]
    try:
        sections = []
        for s in servers:
            s.connect_frames("a")
            s.connect_frames("b")
            sections.append(json.loads(_get(f"{s.telemetry.url}/snapshot")[2])["server"])
        assert sections[1] == sections[0]
        assert sections[1]["slots_assigned"] == 2 and sections[1]["queued_updates"] == 0
        t = servers[1]
        if json.loads(_get(f"{t.telemetry.url}/healthz")[2]).get("last_dispatch") != "never":
            # an earlier test of this process dispatched: the gauges are process-wide
            from ytpu_torch.utils.metrics import metrics

            assert max(metrics.gauge(g).value for g in ("sync.last_dispatch_unix",
                                                         "integrate.last_dispatch_unix")) > 0
        c = TDoc(client_id=40)
        with c.transact() as txn:
            c.get_text("text").insert(txn, 0, "hi")
        w, _ = t.connect_frames("a")
        t.receive_frames(w, Message.sync(SyncMessage.update(c.encode_state_as_update_v1())).encode_v1())
        assert json.loads(_get(f"{t.telemetry.url}/snapshot")[2])["server"]["queued_updates"] == 1
        before = time.time()
        assert t.flush_device() == 1
        health = json.loads(_get(f"{t.telemetry.url}/healthz")[2])
        assert t._last_dispatch.value >= before and 0 <= health["last_dispatch_age_s"] < 60
        assert t.device_text("a") == "hi"
    finally:
        for s in servers:
            s.telemetry.stop()
