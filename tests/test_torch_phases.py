"""The port's phase recorder against the JAX package's, on the CPU.

The same seeded call sequences go to a fresh `PhaseRecorder` of each
package under one deterministic clock, so the comparison is exact:
snapshots, the compile journal and `compile_report` (retrace deltas named
by axis), the memory ledger, the storm provider, the registry families
the sentinel feeds, and the ``compile.retrace`` fault site. Then every
stage and metric family the port emits (its call sites' literals and a
small CPU replay's stages) is named in ``docs/observability.md``, and
`classify_stage` puts every stage name of both packages in the same
profile bucket. (A replay's stages are held to the JAX package's in
``tests/test_torch_overlap.py``, which compiles that replay anyway.)
Neither package's process-wide recorder or registry is reset: each test
swaps in fresh recorders and reads registry deltas.
"""
import ast
import importlib
import os
import re

import numpy as np
import pytest
import torch

from ytpu.utils.faults import faults as y_faults
from ytpu.utils.metrics import metrics as y_metrics
from ytpu.utils.profile import classify_stage as y_classify

from ytpu_torch.utils.faults import faults as t_faults
from ytpu_torch.utils.metrics import metrics as t_metrics
from ytpu_torch.utils.profile import classify_stage as t_classify

from _torch_obs import FakeClock, ObjectDelta, RegistryDelta, swap_module_globals

# the modules (each package's `utils` exports its recorder under the same name)
y_mod = importlib.import_module("ytpu.utils.phases")
t_mod = importlib.import_module("ytpu_torch.utils.phases")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (("ytpu", y_mod, y_faults, y_metrics), ("ytpu_torch", t_mod, t_faults, t_metrics))
STAGES = ("phtest.decode", "phtest.integrate", "phtest.stage", "phtest.host")
AXES = ("state", "rows", "flag")


def _script(seed: int, n: int = 80):
    """A seeded call sequence over `STAGES`: spans with and without keys
    (some with axis names and memory splits), transfers, timed totals and
    the three gauge kinds."""
    rng = np.random.default_rng(seed)
    shapes = [(2, 256), (2, 512), (4, 256)]
    ops = []
    for _ in range(n):
        st = STAGES[int(rng.integers(len(STAGES)))]
        k = int(rng.integers(8))
        if k == 0:
            ops.append(("span", st, None, None, None))
        elif k in (1, 2):
            key = (shapes[int(rng.integers(3))], int(rng.integers(1, 3)) * 16, bool(rng.integers(2)))
            axes = AXES if rng.integers(2) else None
            mem = None
            if rng.integers(2):
                mem = {k_: int(v) for k_, v in zip(
                    ("temp_bytes", "argument_bytes", "output_bytes", "alias_bytes", "generated_code_bytes"),
                    rng.integers(0, 1 << 20, 5))}
            ops.append(("span", st, key, axes, mem))
        elif k == 3:
            ops.append(("transfer", st, int(rng.integers(1 << 16)), ("h2d", "d2h")[int(rng.integers(2))]))
        elif k == 4:
            ops.append(("add_time", st, float(rng.integers(1, 1000)) / 1e4, int(rng.integers(1, 4))))
        elif k == 5:
            ops.append(("set_value", st, float(rng.integers(100)) / 7))
        elif k == 6:
            ops.append(("add_value", st, float(rng.integers(100))))
        else:
            ops.append(("set_max", st, float(rng.integers(100))))
    return ops


def _play(rec, ops):
    for op in ops:
        if op[0] == "span":
            _, st, key, axes, mem = op
            with rec.span(st, key, axes=axes, memory=(lambda m=mem: m) if mem else None):
                pass
        else:
            getattr(rec, op[0])(*op[1:])


def _both(monkeypatch, ops, marker_at=None):
    """Play `ops` on a fresh enabled recorder of each package, each under
    its own fake clock; returns the recorders and each package's registry
    delta over the run (compile and memory families)."""
    out = []
    for _, mod, _, reg in PACKAGES:
        monkeypatch.setattr(mod, "time", FakeClock())
        rec = mod.PhaseRecorder(enabled=True)
        tally = RegistryDelta(reg)
        marker = None
        if marker_at is None:
            _play(rec, ops)
        else:
            _play(rec, ops[:marker_at])
            marker = rec.compile_marker()
            _play(rec, ops[marker_at:])
        out.append((rec, tally.changed(("compile.", "memory.")), marker))
    return out


@pytest.mark.parametrize("seed", [3, 11])
def test_recorder_matches_ytpu(monkeypatch, seed):
    ops = _script(seed)
    (yr, yd, ym), (tr, td, tm) = _both(monkeypatch, ops, marker_at=30)
    assert tr.snapshot() == yr.snapshot()
    assert tr.compile_events() == yr.compile_events()
    assert ym == tm
    assert tr.compile_report(since=tm) == yr.compile_report(since=ym)
    assert tr.compile_report() == yr.compile_report()
    rep = tr.compile_report()
    assert rep["retraces"] > 0 and all(e["delta"] for e in rep["journal"])
    assert {d["axis"] for e in rep["journal"] for d in e["delta"]} & set(AXES)
    assert tr.memory_report() == yr.memory_report()
    for budget in (None, 0, 1, 100):
        assert (t_mod.compile_storm_provider(budget, tm, recorder=tr)()
                == y_mod.compile_storm_provider(budget, ym, recorder=yr)())
    assert td == yd and any(k.startswith("compile.events") for k in td)
    for rec in (tr, yr):
        rec.reset()
        assert rec.snapshot() == {} and rec.compile_report()["events"] == 0


def test_disabled_recorder_is_one_attribute_check():
    rec = t_mod.PhaseRecorder()
    assert rec.span("x", key=(1,)) is t_mod.NULL_SPAN
    rec.transfer("x", 5)
    rec.add_time("x", 1.0)
    rec.set_value("x", 1.0)
    rec.add_value("x", 1.0)
    rec.set_max("x", 1.0)
    assert rec.snapshot() == {} and rec.compile_events() == []


def test_retrace_fault_site_matches_ytpu(monkeypatch):
    ops = [("span", "phtest.decode", ((2, 256), 16, True), AXES, None)] * 4
    ops += [("span", "phtest.integrate", ((2, 256), 16, True), None, None)] * 3
    # read from the counters the fault modules made at import
    tallies = [ObjectDelta(importlib.import_module(f"{pkg}.utils.faults")._INJECTED_BY_SITE)
               for pkg in ("ytpu", "ytpu_torch")]
    for _, _, faults, _ in PACKAGES:
        faults.arm("compile.retrace", n=2, program="phtest.decode")
    try:
        (yr, _, _), (tr, _, _) = _both(monkeypatch, ops)
    finally:
        for _, _, faults, _ in PACKAGES:
            faults.clear()
    assert tr.compile_events() == yr.compile_events()
    assert tr.compile_report()["retraces"] == yr.compile_report()["retraces"] == 2
    assert tr.snapshot() == yr.snapshot()
    site = 'faults.injected_by_site{site="compile.retrace"}'
    assert tallies[1].changed() == tallies[0].changed() == {site: 2}


def test_program_memory_twin_names_the_same_kinds():
    """The port's `program_memory` reports the JAX package's kind names
    (its thunk reads the launch's tensors, no device access): arguments,
    outputs and in-place aliasing in bytes, as XLA's analysis counts them
    for the same shapes."""
    import jax
    import jax.numpy as jnp

    y = y_mod.program_memory(jax.jit(lambda a, b: a + b), jnp.zeros(64, jnp.int32), jnp.ones(64, jnp.int32))()
    a, b = torch.zeros(64, dtype=torch.int32), torch.ones(64, dtype=torch.int32)
    out = []
    thunk = t_mod.program_memory(a, b, outputs=lambda: out, scratch_bytes=lambda: 96)
    out.append(a + b)
    t = thunk()
    assert set(t) == set(y)
    for k in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert t[k] == y[k], k
    assert t["temp_bytes"] == 96 and t["generated_code_bytes"] == 0
    inplace = t_mod.program_memory(a, b, outputs=(a,), aliased=(a,))()
    assert (inplace["argument_bytes"], inplace["output_bytes"], inplace["alias_bytes"]) == (512, 256, 256)


# --- the port's stage names ----------------------------------------------------

_PORT_STAGES = {}


def _port_replay_stages(monkeypatch):
    """The port's phase snapshot of the overlap lane's raw replay of
    `test_async_overlap`'s workload (made once per module; the JAX
    package's stages of the same run are held to it in
    ``tests/test_torch_overlap.py``, which compiles that family anyway)."""
    if not _PORT_STAGES:
        from ytpu_torch.models import replay as treplay

        from test_async_overlap import CAPACITY, CHUNK, N_DOCS, _workload

        log = _workload()[0]
        rec = t_mod.PhaseRecorder(enabled=True)
        swap_module_globals(monkeypatch, "ytpu_torch", t_mod.phases, rec)
        treplay.FusedReplay(N_DOCS, treplay.plan_replay(log), capacity=CAPACITY, max_capacity=CAPACITY,
                            chunk=CHUNK, device="cpu", overlap=True, ingest="raw").run(log)
        _PORT_STAGES["snap"] = rec.snapshot()
    return _PORT_STAGES["snap"]


# --- the names check -----------------------------------------------------------

_PHASE_CALLS = {"span", "transfer", "add_time", "set_value", "add_value", "set_max"}
_METRIC_CALLS = {"counter", "gauge", "histogram"}
# the overlap engine's four generic gauges: docs/observability.md names
# them under the replay and encode prefixes the JAX package documents;
# UpdatePipeline runs the same engine under the "pipeline" prefix
_ENGINE = re.compile(r"^pipeline\.(stage|stall|overlap_ratio|inflight_depth)$")


def _emitted_names():
    """``(metric families, phase stages)`` named by string literals at the
    port's registry and recorder call sites."""
    families, stages = set(), set()
    for base, _, files in os.walk(os.path.join(ROOT, "ytpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(base, f)).read())
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.args):
                    continue
                arg, fn, recv = node.args[0], node.func.attr, node.func.value
                if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
                    continue
                rname = recv.id if isinstance(recv, ast.Name) else getattr(recv, "attr", "")
                if fn in _METRIC_CALLS and "metrics" in rname:
                    families.add(arg.value)
                elif fn in _PHASE_CALLS and "phases" in rname:
                    stages.add(arg.value)
    return families, stages


def test_every_emitted_name_is_documented(monkeypatch):
    families, stages = _emitted_names()
    stages |= set(_port_replay_stages(monkeypatch))
    families |= set(t_metrics._families)
    assert {"sync.apply_update", "compile.events", "admission.rejected", "telemetry.scrapes"} <= families
    assert {"decode.v1", "ingest.plan", "replay.chunk_raw", "encode.pack", "pipeline.decode"} <= stages
    doc = open(os.path.join(ROOT, "docs", "observability.md")).read()
    missing = sorted(f"metric: {n}" for n in families if n not in doc)
    for n in stages:
        base = re.sub(r"\.(fused|xla|host)$", "", _ENGINE.sub(r"replay.\1", n))
        if base not in doc:
            missing.append(f"phase: {n}")
    assert not missing, missing


def test_classify_stage_matches_ytpu_over_both_packages_names(monkeypatch):
    from ytpu.utils import profile as yprof
    from ytpu_torch.utils import profile as tprof

    assert tprof._PREFIX_RULES == yprof._PREFIX_RULES and tprof._BUCKETS == yprof._BUCKETS
    doc = open(os.path.join(ROOT, "docs", "observability.md")).read()
    listed = doc[doc.index("Phase stages:"):doc.index("## Roofline")]
    names = set(re.findall(r"`([a-z_0-9]+(?:\.[a-z_0-9]+)+)`", listed)) | set(_port_replay_stages(monkeypatch))
    names |= _emitted_names()[1] | {"rehearsal.x", "host.load_log", "encode.stage", "x.stall", "x.drain"}
    assert len(names) > 60
    assert {n: t_classify(n) for n in names} == {n: y_classify(n) for n in names}
