"""The port's flight-recorder tracer against the JAX package's, on the CPU.

Fresh `Tracer`s of both packages, each under one deterministic clock,
take the same seeded sequence of spans, instants and request contexts;
their Chrome-trace exports must be equal event for event (names, phases,
args, timestamps and so nesting). Also the ring's drop-oldest eviction,
`dump_on_error` through ``YTPU_TRACE`` (the ``%p`` pid template, a bad
path), the context helpers (`trace_context`, `resume_trace`,
`current_trace(_id)`), and the disabled path. Each package's process-wide
tracer is swapped out for the test and restored, never cleared.
"""

import importlib
import json
import os

import numpy as np
import pytest

from _torch_obs import FakeClock, swap_module_globals

y_mod = importlib.import_module("ytpu.utils.trace")
t_mod = importlib.import_module("ytpu_torch.utils.trace")
PACKAGES = (("ytpu", y_mod), ("ytpu_torch", t_mod))


@pytest.fixture
def tracers(monkeypatch):
    """A fresh enabled `Tracer` per package in place of its process-wide
    one, each on its own fake clock."""
    out = []
    for pkg, mod in PACKAGES:
        clock = FakeClock()
        monkeypatch.setattr(mod, "time", clock)
        tr = mod.Tracer(enabled=True, max_events=4096)
        swap_module_globals(monkeypatch, pkg, mod.tracer, tr)
        out.append(tr)
    return out


def _script(mod, tr, seed: int):
    """A seeded nest of request contexts, spans and instants on `tr`."""
    rng = np.random.default_rng(seed)

    def body(depth):
        for i in range(int(rng.integers(1, 4))):
            k = int(rng.integers(4))
            if k == 0:
                tr.instant("net.frame", n=int(rng.integers(100)), depth=depth)
            elif k == 1 and depth < 3:
                with tr.span("sync.dispatch", step=i, traces=[f"t{j}" for j in range(int(rng.integers(3)))]):
                    body(depth + 1)
            elif k == 2 and depth < 3:
                with mod.trace_context(trace=f"req-{seed}-{depth}-{i}", tenant=f"ten{int(rng.integers(3))}"):
                    assert mod.current_trace_id() == f"req-{seed}-{depth}-{i}"
                    with tr.span("apply_update", tenant="override"):
                        body(depth + 1)
            else:
                with mod.resume_trace(f"fleet-{i}", origin="r1", session=i):
                    tr.instant("replica.frame", depth=depth)
                    with tr.span("admission.admit", depth=depth, n=1):
                        pass

    with mod.trace_context(trace=f"outer-{seed}", session=seed):
        body(0)
    assert mod.current_trace() is None


@pytest.mark.parametrize("seed", [5, 17, 29])
def test_chrome_trace_matches_ytpu(tracers, seed):
    events = []
    for (_, mod), tr in zip(PACKAGES, tracers):
        _script(mod, tr, seed)
        events.append(json.loads(tr.export_chrome_trace())["traceEvents"])
    y, t = events
    assert len(t) == len(y) > 4
    assert t == y
    # nesting: every complete event lies inside the events that opened
    # before it and closed after it, the same in both
    spans = [e for e in t if e["ph"] == "X"]
    assert any(a is not b and a["ts"] <= b["ts"] and b["ts"] + b["dur"] <= a["ts"] + a["dur"]
               for a in spans for b in spans)


def test_ring_drops_oldest_like_ytpu(monkeypatch):
    exports = []
    for _, mod in PACKAGES:
        monkeypatch.setattr(mod, "time", FakeClock())
        tr = mod.Tracer(enabled=True, max_events=5)
        for i in range(12):
            with tr.span("s", i=i):
                tr.instant("i", i=i)
        assert len(tr) == 5
        exports.append(json.loads(tr.export_chrome_trace())["traceEvents"])
        tr.clear()
        assert len(tr) == 0
    assert exports[1] == exports[0]
    assert [e["args"]["i"] for e in exports[0]] == [9, 10, 10, 11, 11]


def test_dump_on_error_with_ytpu_trace(tracers, monkeypatch, tmp_path):
    monkeypatch.setenv("YTPU_TRACE", str(tmp_path / "trace-%p.json"))
    dumps = []
    for (pkg, mod), tr in zip(PACKAGES, tracers):
        tr.enabled = False  # dumps even when never enabled
        with mod.trace_context(trace="never"):
            pass
        path = tr.dump_on_error(error=ValueError("device step failed"))
        assert path == str(tmp_path / f"trace-{os.getpid()}.json")
        dumps.append(json.load(open(path)))
        assert tr.enabled is False
        assert tr.dump_on_error(path=str(tmp_path / "missing" / "x.json"), error=KeyError("k")) is None
        assert tr.dump_on_error(path=str(tmp_path / f"{pkg}.json")) == str(tmp_path / f"{pkg}.json")
    assert dumps[1] == dumps[0]
    (err,) = dumps[0]["traceEvents"]
    assert err["args"] == {"type": "ValueError", "message": "device step failed"}
    monkeypatch.delenv("YTPU_TRACE")
    assert tracers[1].dump_on_error(error=RuntimeError()) is None


def test_disabled_tracer_allocates_nothing(monkeypatch):
    from ytpu_torch.utils.phases import NULL_SPAN

    tr = t_mod.Tracer()
    swap_module_globals(monkeypatch, "ytpu_torch", t_mod.tracer, tr)
    assert tr.span("x", a=1) is NULL_SPAN
    assert t_mod.trace_context() is NULL_SPAN and t_mod.trace_span("x") is NULL_SPAN
    tr.instant("x")
    assert len(tr) == 0 and t_mod.current_trace_id() is None
    a, b = t_mod.new_trace_id(), t_mod.new_trace_id()
    assert a != b and a.startswith(f"t{os.getpid():x}-")
