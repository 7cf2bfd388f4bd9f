"""The port's fault-tolerant replay against the JAX package's, on the CPU:
kill -> resume from a checkpoint or from scratch, the continuation rules,
the recovery budget, poison-update quarantine on the serial, raw and
packed lanes, and a staging fault. Each scenario arms the same fault in
both packages' injectors (two registries) and compares the text, the
state, the resilience counters, the metrics and the error.

The replays reuse `test_async_overlap`'s workload and shape family; the
JAX package runs every scenario once, in one module fixture.
"""

import importlib

import numpy as np
import pytest
import torch

from ytpu.core import Doc
from ytpu.models import replay as jreplay
from ytpu.native import available as native_available
from ytpu.ops import integrate_kernel as jik
from ytpu.utils.faults import FaultSpec as JFaultSpec
from ytpu.utils.faults import faults as j_faults
from ytpu.utils.metrics import metrics as j_metrics

from ytpu_torch.models import replay as treplay
from ytpu_torch.ops import integrate_kernel as tik
from ytpu_torch.utils.faults import FaultError, FaultSpec, faults
from ytpu_torch.utils.metrics import metrics

from test_async_overlap import CAPACITY, CHUNK, N_DOCS, _workload
from test_torch_integrate import OS
from test_torch_overlap import _port_plan

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(not native_available(), reason="native codec unavailable (JAX plan pre-scan)")


def _clear():
    j_faults.clear()
    faults.clear()
    jik.reset_lane_health()


@pytest.fixture(autouse=True)
def _clean_slate():
    """Armed faults are process-global in both packages: every test starts
    and ends with both injectors cleared."""
    _clear()
    yield
    _clear()


def _poison():
    return len(_workload()[0]) - 1


# name -> (FusedReplay keywords, fault site, arm keywords, runs before the fault)
SCENARIOS = {
    "kill_checkpoint_serial": (dict(checkpoint_every=2), "replay.kill", dict(after=3), 0),
    "kill_scratch_serial": (dict(), "replay.kill", dict(after=2), 0),
    "kill_checkpoint_raw": (dict(overlap=True, checkpoint_every=2), "replay.kill", dict(after=2), 0),
    "kill_scratch_packed": (dict(overlap=True, ingest="packed"), "replay.kill", dict(after=2), 0),
    "continuation_checkpoint": (dict(checkpoint_every=4), "replay.kill", dict(), 1),
    "continuation_no_checkpoint": (dict(), "replay.kill", dict(), 1),
    "recovery_budget": (dict(max_recoveries=2), "replay.kill", dict(n=0), 0),
    "quarantine_serial": (dict(quarantine=True), "update.corrupt", "poison", 0),
    "quarantine_raw": (dict(overlap=True, ingest="raw", quarantine=True), "update.corrupt", "poison", 0),
    "quarantine_packed": (dict(overlap=True, ingest="packed", quarantine=True), "update.corrupt", "poison", 0),
    "poison_serial": (dict(), "update.corrupt", "poison", 0),
    "poison_raw": (dict(overlap=True), "update.corrupt", "poison", 0),
    "staging_fault": (dict(overlap=True), "stage.raise", dict(prefix="replay"), 0),
}
METRICS = ("replay.recoveries", "replay.quarantined", "faults.injected")
# the counters each package's modules took from its registry at import
# time; an earlier test's `metrics.reset()` in the same process leaves them
# out of the registry, so a count is read from every object that holds it
_J_FAULTS = importlib.import_module("ytpu.utils.faults")  # the package exports the injector under this name
_T_FAULTS = importlib.import_module("ytpu_torch.utils.faults")
CACHED = {
    "jax": {"faults.injected": [_J_FAULTS._INJECTED], "replay.quarantined": [jik._QUARANTINED],
            "replay.recoveries": [jik._RECOVERIES]},
    "port": {"faults.injected": [_T_FAULTS._INJECTED], "replay.quarantined": [tik._QUARANTINED]},
}


def _count(pkg: str, registry, name: str) -> int:
    held = {id(c): c for c in [registry.counter(name), *CACHED[pkg].get(name, ())]}
    return sum(c.value for c in held.values())


def _run(pkg: str, name: str) -> dict:
    """One scenario in one package: the outcome both must agree on."""
    kw, site, arm, warm_runs = SCENARIOS[name]
    log, _, jplan = _workload()
    if pkg == "jax":
        rep = jreplay.FusedReplay(n_docs=N_DOCS, plan=jplan, capacity=CAPACITY, max_capacity=CAPACITY,
                                  chunk=CHUNK, lane="xla", **kw)
        injector, registry = j_faults, j_metrics
    else:
        rep = treplay.FusedReplay(N_DOCS, _port_plan(), capacity=CAPACITY, max_capacity=CAPACITY,
                                  chunk=CHUNK, device="cpu", **kw)
        injector, registry = faults, metrics
    for _ in range(warm_runs):
        rep.run(log)
    before = {m: _count(pkg, registry, m) for m in METRICS}
    injector.arm(site, **(dict(after=_poison()) if arm == "poison" else arm))
    error = None
    try:
        rep.run(log)
    except Exception as e:  # the outcome under comparison
        error = (type(e).__name__, str(e))
    finally:
        injector.clear()
    st = rep.stats
    # after an error the JAX state may have been donated: read no state
    return {
        "error": error,
        "texts": None if error else [rep.get_string(d) for d in range(N_DOCS)],
        "cols": None if error else np.delete(np.array(rep.cols), OS, axis=0),
        "meta": None if error else np.array(rep.meta),
        "counters": {k: getattr(st, k) for k in ("resumes", "recoveries", "checkpoints", "quarantined", "chunks",
                                                  "compactions", "ingest")},
        "metrics": {m: _count(pkg, registry, m) - before[m] for m in METRICS},
    }


@pytest.fixture(scope="module")
def jax_outcomes():
    if not native_available():
        pytest.skip("native codec unavailable (JAX plan pre-scan)")
    out = {}
    for name in SCENARIOS:
        _clear()
        out[name] = _run("jax", name)
    _clear()
    return out


def _host_text(log):
    doc = Doc()
    for p in log:
        doc.apply_update_v1(p)
    return doc.get_text("text").get_string()


def _expect_outcome(name: str, got: dict) -> None:
    """What a scenario must show in the port, beyond agreeing with the JAX
    package."""
    log, expect, _ = _workload()
    counters, error = got["counters"], got["error"]
    if name.startswith("kill_") or name in ("continuation_checkpoint", "staging_fault"):
        assert error is None and got["texts"] == [expect] * N_DOCS
        assert counters["recoveries"] >= 1
    if name.startswith("kill_checkpoint"):
        assert counters["resumes"][0] > 0 and counters["checkpoints"] >= 1
    if name.startswith("kill_scratch") or name == "continuation_checkpoint":
        assert counters["resumes"] == [0]
    if name in ("continuation_no_checkpoint", "recovery_budget"):
        assert error[0] == "ReplayFault"
    if name == "recovery_budget":
        assert counters["recoveries"] == 2
    if name.startswith("quarantine_"):
        assert counters["quarantined"] == [_poison()]
        assert got["texts"] == [_host_text(log[:-1])] * N_DOCS
        assert got["metrics"]["replay.quarantined"] == 1
    if name.startswith("poison_"):
        assert error[0] == "RuntimeError" and f"flagged updates [{_poison()}]" in error[1]


@needs_native
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax(jax_outcomes, name):
    want = jax_outcomes[name]
    got = _run("port", name)
    assert got["error"] == want["error"]
    assert got["counters"] == want["counters"]
    assert got["metrics"] == want["metrics"]
    assert got["texts"] == want["texts"]
    if got["cols"] is not None:
        np.testing.assert_array_equal(got["cols"], want["cols"])
        np.testing.assert_array_equal(got["meta"], want["meta"])
    _expect_outcome(name, got)


@needs_native
def test_resume_survives_a_second_fault_from_one_checkpoint():
    """Two kills after the same checkpoint: the second resume still finds
    the snapshot intact, because the restore copies it."""
    log, expect, _ = _workload()
    rep = treplay.FusedReplay(N_DOCS, _port_plan(), capacity=CAPACITY, max_capacity=CAPACITY, chunk=CHUNK,
                              checkpoint_every=8, device="cpu")
    faults.arm("replay.kill", after=9, n=2)
    rep.run(log)
    assert rep.stats.resumes == [8 * CHUNK, 8 * CHUNK]
    assert rep.get_string(0) == expect


@needs_native
def test_checkpoint_is_a_copy():
    """The snapshot does not alias the state that the next chunk writes in
    place."""
    log, _, _ = _workload()
    rep = treplay.FusedReplay(N_DOCS, _port_plan(), capacity=CAPACITY, max_capacity=CAPACITY, chunk=CHUNK,
                              device="cpu")
    rep.run(log[: 2 * CHUNK])
    rep._checkpoint_now(pos=0)
    snap = rep._ckpt.cols.copy()
    rep.cols.add_(1)
    np.testing.assert_array_equal(rep._ckpt.cols, snap)
    assert rep.stats.checkpoints == 1 and rep.stats.checkpoint_bytes == rep._ckpt.cols.nbytes + rep._ckpt.meta.nbytes


def test_fault_injectors_are_separate_registries():
    """Arming one package's injector leaves the other's quiet; the grammar
    and the deterministic schedule are the same."""
    faults.configure("replay.kill:after=2;update.corrupt:mode=flip,n=3")
    assert not j_faults.active
    specs = faults._specs
    assert specs["replay.kill"][0].after == 2 and specs["update.corrupt"][0].n == 3
    assert [faults.fire("replay.kill") is not None for _ in range(4)] == [False, False, True, False]
    a = FaultSpec("x", n=0, p=0.5, seed=7)
    b = JFaultSpec("x", n=0, p=0.5, seed=7)
    assert [a._decide() for _ in range(32)] == [b._decide() for _ in range(32)]
    payload = bytes(range(40))
    assert faults.corrupt("update.corrupt", payload) != payload
    with faults.suspended():
        assert faults.fire("update.corrupt") is None


def test_replay_fault_carries_its_cause():
    spec = faults.arm("replay.kill")
    e = tik.ReplayFault("x", chunk=3, cause=FaultError("replay.kill", spec))
    assert e.chunk == 3 and e.cause.site == "replay.kill" and isinstance(e, RuntimeError)
