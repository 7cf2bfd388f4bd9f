"""The port's pipelined replay against the JAX package's, on the CPU: the
overlap engine (`OverlapPipeline`, `plan_overlap`), `FusedReplay`'s serial
lane and its overlap lane on raw and host-packed staging at depths 1-3
(cols, meta, every chunk's readout, text and counters), the slot-reuse
staging, the deferred decode error's message, and the phase recorder's
stages of every lane.

Every replay reuses `test_async_overlap`'s workload and its (2 docs,
capacity 256, chunk 16) shape family; the JAX package runs each lane once
(XLA lane), in one module fixture.
"""

import time
from functools import lru_cache

import numpy as np
import pytest
import torch

from ytpu.models import replay as jreplay
from ytpu.native import available as native_available
from ytpu.ops import integrate_kernel as jik

from ytpu_torch.models import replay as treplay
from ytpu_torch.ops import integrate_kernel as tik

from test_async_overlap import CAPACITY, CHUNK, N_DOCS, _workload
from test_torch_integrate import OS, assert_meta, assert_planes
from _torch_obs import swap_module_globals

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(not native_available(), reason="native codec unavailable (JAX plan pre-scan)")

# (name, FusedReplay keywords): the lanes both packages run
LANES = {
    "serial": dict(overlap=False),
    "raw": dict(overlap=True, ingest="raw"),
    "packed": dict(overlap=True, ingest="packed"),
}
# the readout counters both packages fill
COUNTERS = ("chunks", "compactions", "growths", "syncs", "peak_blocks", "final_blocks", "capacity",
            "commit_word", "occupied_rows", "dead_rows", "dead_max", "reclaimed_rows", "scan_hist",
            "scan_max", "scan_p50", "scan_p99", "scan_tier_cheap", "scan_tier_wide", "scan_trips_serial",
            "scan_trips_two_tier", "compact_gap_chunks", "ingest", "stage_bytes", "buffer_reuses")


def _jax(log, **kw):
    return jreplay.FusedReplay(n_docs=N_DOCS, plan=_workload()[2], capacity=CAPACITY, max_capacity=CAPACITY,
                               chunk=CHUNK, lane="xla", **kw)


@lru_cache(maxsize=1)
def _port_plan():
    return treplay.plan_replay(_workload()[0])


def _port(log, **kw):
    """The port's replay of the workload's plan (`log` may be a corrupted
    copy of the workload)."""
    return treplay.FusedReplay(N_DOCS, _port_plan(), capacity=CAPACITY, max_capacity=CAPACITY,
                               chunk=CHUNK, device="cpu", **kw)


def _run_recorded(make, log, driver_cls, to_numpy):
    """``(replay, readouts)``: `make(log)` run over `log`, recording every
    chunk readout (in dispatch order) as the driver drains it. The JAX
    driver drains the readout of a compaction inside `compact`, the port
    reads it there directly: readouts drained inside `compact` are not
    recorded."""
    drain, compact = driver_cls._drain_readouts, driver_cls.compact
    out = []
    in_compact = []

    def rec_drain(self):
        if not in_compact:
            out.extend(to_numpy(r) for r in self._pending)
        return drain(self)

    def rec_compact(self):
        in_compact.append(True)
        try:
            return compact(self)
        finally:
            in_compact.pop()

    mp = pytest.MonkeyPatch()
    mp.setattr(driver_cls, "_drain_readouts", rec_drain)
    mp.setattr(driver_cls, "compact", rec_compact)
    try:
        rep = make(log)
        rep.run(log)
    finally:
        mp.undo()
    return rep, out


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX replay per lane: ``{lane: (replay, chunk readouts)}``."""
    log, _, _ = _workload()
    return {name: _run_recorded(lambda lg: _jax(lg, **kw), log, jik.PackedReplayDriver, np.array)
            for name, kw in LANES.items()}


def _assert_same(port, readouts, jax, j_readouts, counters=COUNTERS):
    assert_planes(port.cols.numpy(), np.asarray(jax.cols), skip=(OS,))
    assert_meta(port.meta.numpy(), np.asarray(jax.meta))
    assert len(readouts) == len(j_readouts) == port.stats.chunks
    for k, (a, b) in enumerate(zip(readouts, j_readouts)):
        np.testing.assert_array_equal(a, b, err_msg=f"chunk {k}")
    for name in counters:
        assert getattr(port.stats, name) == getattr(jax.stats, name), name
    for d in range(N_DOCS):
        assert port.get_string(d) == jax.get_string(d)


@needs_native
@pytest.mark.parametrize("lane,depth", [("serial", 2), ("raw", 1), ("raw", 2), ("raw", 3), ("packed", 1),
                                        ("packed", 2), ("packed", 3)])
def test_lane_matches_jax(jax_runs, lane, depth):
    """Every lane and depth of the port ends in the JAX package's state,
    chunk readouts, text and counters (its run at depth 2 of the same
    lane; the depth changes nothing the device computes)."""
    log, expect, _ = _workload()
    jax, j_readouts = jax_runs[lane]
    port, readouts = _run_recorded(lambda lg: _port(lg, depth=depth, **LANES[lane]), log,
                                   tik.PackedReplayDriver, lambda r: r.numpy().copy())
    counters = COUNTERS if depth == 2 else tuple(c for c in COUNTERS if c != "buffer_reuses")
    _assert_same(port, readouts, jax, j_readouts, counters)
    assert port.get_string(0) == expect
    assert port.stats.compactions >= 1 and port.stats.growths == 0
    if lane != "serial":
        assert port.stats.buffer_reuses == port.stats.chunks - depth
        assert 1 <= port.stats.max_inflight <= depth
        assert port.stats.syncs < port.stats.chunks
        assert 0.0 <= port.stats.overlap_ratio <= 1.0


@needs_native
def test_serial_and_overlap_lanes_agree_bitwise(jax_runs):
    """The serial lane (a blocking drain a chunk) and the overlap lane end
    in the same cols, every plane, and the same meta; `compact` after
    the run."""
    log, _, _ = _workload()
    serial, raw = _port(log, **LANES["serial"]), _port(log, **LANES["raw"])
    serial.run(log)
    raw.run(log)
    assert torch.equal(serial.cols, raw.cols) and torch.equal(serial.meta, raw.meta)
    assert serial.stats.syncs == serial.stats.chunks + serial.stats.compactions
    assert raw.stats.ingest == "raw" and serial.stats.ingest == ""
    # a forced compaction keeps the text and reports the new high-water mark
    text = serial.get_string(0)
    hi = serial.compact()
    assert hi == int(serial.meta[:, tik.M_NBLOCKS].max()) and serial.stats.compactions == raw.stats.compactions + 1
    assert serial.get_string(0) == text


@needs_native
def test_zero_sync_steady_state():
    """On a prefix whose occupancy bound never trips the watermark, the
    overlap lane drains its readouts once, at `finish()`."""
    log, _, _ = _workload()
    stats = _port(log, overlap=True).run(log[: 3 * CHUNK])
    assert stats.chunks == 3 and stats.compactions == 0 and stats.syncs == 1


@needs_native
@pytest.mark.parametrize("lane", list(LANES))
def test_deferred_decode_error_same_message(lane):
    """A truncated update: every lane of both packages raises the same
    message naming it (the overlap lane finds it again on the host after
    the deferred sticky flags)."""
    log, _, _ = _workload()
    bad = list(log)
    bad[37] = bad[37][: len(bad[37]) // 2]
    with pytest.raises(RuntimeError, match="flagged updates") as j_err:
        _jax(bad, **LANES[lane]).run(bad)
    with pytest.raises(RuntimeError, match="flagged updates") as t_err:
        _port(bad, **LANES[lane]).run(bad)
    assert str(t_err.value) == str(j_err.value)
    assert "[37]" in str(t_err.value)


@needs_native
def test_driver_deferred_decode_error_same_message():
    """Without a caller's hook, both drivers raise the same deferred
    message, which names the driver's own `sync_every_chunk` knob."""
    from ytpu.models.batch_doc import init_state as j_init
    from ytpu.ops.decode_kernel import identity_rank as j_rank
    from ytpu_torch.models.batch_doc import init_state as t_init
    from ytpu_torch.ops.decode_kernel import identity_rank as t_rank

    log, _, _ = _workload()
    bad = list(log)
    bad[37] = bad[37][: len(bad[37]) // 2]
    plan = _port_plan()
    # the chunk holding update 37, staged as the raw lane stages the log
    slot = next(s for s in _port(log).stage_chunks(bad) if s.pos <= 37 < s.end)
    dims = (plan.max_rows, plan.max_dels, plan.max_steps, plan.max_sections)
    width = plan.max_len + 16
    errors = []
    for ik, cols_meta, rank in ((jik, jik.pack_state(j_init(N_DOCS, CAPACITY)), j_rank(256)),
                                (tik, tik.pack_state(t_init(N_DOCS, CAPACITY, "cpu")), t_rank(256, "cpu"))):
        kw = {"lane": "xla"} if ik is jik else {}
        drv = ik.PackedReplayDriver(*cols_meta, rank, unit_refs=True, gc_ranges=True, **kw)
        drv.step_raw(slot.raw, slot.offs, slot.lens, slot.refs, dims, width, margin=64)
        with pytest.raises(RuntimeError, match="deferred chunk") as err:
            drv.finish()
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "sync_every_chunk=True" in errors[1]


# --- the overlap engine ---------------------------------------------------------------


def test_raising_producer_never_strands_consumer():
    """A staging generator that raises shuts the loop down: the error
    re-raises on the caller promptly, and the engine runs again."""
    pipe = treplay.OverlapPipeline(depth=2, stage_prefix="chaos")
    consumed = []

    def produce():
        yield 1
        yield 2
        yield 3
        raise RuntimeError("staging boom")

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="staging boom"):
        pipe.run(produce(), lambda x: (time.sleep(0.05), consumed.append(x)))
    assert time.perf_counter() - t0 < 5.0, "consumer was stranded"
    stats = pipe.run(iter([10, 11]), consumed.append)
    assert stats.consumed == 2 and consumed[-2:] == [10, 11]


def test_raising_consumer_stops_producer():
    """A consumer that raises stops a producer blocked on a full queue."""
    pipe = treplay.OverlapPipeline(depth=1)

    def consume(x):
        raise ValueError("dispatch boom")

    with pytest.raises(ValueError, match="dispatch boom"):
        pipe.run(iter(range(100)), consume)
    assert pipe.stopping


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_engine_counts(depth):
    """Both engines consume every item in order and count the same."""
    for engine in (jreplay.OverlapPipeline, treplay.OverlapPipeline):
        seen = []
        stats = engine(depth=depth).run(iter(range(7)), seen.append)
        assert seen == list(range(7))
        assert (stats.staged, stats.consumed) == (7, 7)
        assert 1 <= stats.max_depth <= depth and 0.0 <= stats.overlap_ratio <= 1.0
    with pytest.raises(ValueError, match="depth"):
        treplay.OverlapPipeline(depth=0)


@needs_native
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_overlap_plan_matches(depth):
    log, _, _ = _workload()
    for n in (0, CHUNK, len(log)):
        assert vars(treplay.plan_overlap(n, CHUNK, depth)) == vars(jreplay.plan_overlap(n, CHUNK, depth))
    assert vars(_port(log, overlap=True, depth=depth).overlap_plan()) == vars(
        jreplay.plan_overlap(len(log), CHUNK, depth))
    with pytest.raises(ValueError, match="depth"):
        _port(log, depth=0)
    with pytest.raises(ValueError, match="ingest"):
        _port(log, ingest="lanes")


def test_pack_updates_into_reuse_equals_jax():
    """Restaging a slot writes the same bytes in both packages: a shorter
    payload over a longer one zeroes the old tail."""
    from ytpu.ops.decode_kernel import pack_updates_into as j_pack
    from ytpu_torch.ops.decode_kernel import pack_updates_into as t_pack

    bufs = []
    for pack in (j_pack, t_pack):
        buf = np.zeros((4, 64), dtype=np.uint8)
        lens = np.zeros((4,), dtype=np.int32)
        pack([b"\x01" * 40, b"\x02" * 8], buf, lens)
        pack([b"\x03" * 6], buf, lens)
        bufs.append((buf, lens))
        with pytest.raises(ValueError, match="exceeds staging width"):
            pack([b"\x04" * 60], buf, lens)
    np.testing.assert_array_equal(bufs[0][0], bufs[1][0])
    np.testing.assert_array_equal(bufs[0][1], bufs[1][1])
    assert not bufs[1][0][0, 6:56].any()


def test_staging_slots_are_views_of_their_tensors():
    """A slot's numpy arrays are the memory of the tensors the driver
    copies from, so staging and the copy see the same bytes."""
    slot = treplay._RawStagingSlot(128, 8, 2)
    slot.raw[:3] = 7
    slot.refs[0, 1] = 5
    raw, offs, lens, refs = slot.host
    assert raw[:3].tolist() == [7, 7, 7] and int(refs[0, 1]) == 5 and int(refs[1, 0]) == -1
    packed = treplay._StagingSlot(8, 32, 2)
    packed.buf[1, 2] = 9
    assert int(packed.host[0][1, 2]) == 9 and packed.host[0].shape == (8, 32)


def _stages_by_bucket(pkg, make, log):
    """``{profile bucket: {stage: (calls, compile calls, h2d, d2h)}}`` of
    one run of ``make(log)`` under a fresh recorder of package `pkg`
    (its process-wide recorder is swapped out, not reset); stage names
    of the JAX package's XLA lane are renamed to the port's one lane, the
    kernel the JAX package calls "fused"."""
    import importlib
    import re

    mod = importlib.import_module(f"{pkg}.utils.phases")
    classify = importlib.import_module(f"{pkg}.utils.profile").classify_stage
    rec = mod.PhaseRecorder(enabled=True)
    with pytest.MonkeyPatch.context() as mp:
        swap_module_globals(mp, pkg, mod.phases, rec)
        rep = make(log)
        rep.run(log)
    out = {}
    for name, d in rec.snapshot().items():
        name = re.sub(r"(chunk_|\.)xla$", r"\1fused", name)
        out.setdefault(classify(name), {})[name] = (d["calls"], d["compile_calls"], d["h2d_bytes"], d["d2h_bytes"])
    return out, rep


@needs_native
@pytest.mark.parametrize("lane", list(LANES))
def test_lane_records_jax_stages_in_every_bucket(jax_runs, lane):
    """With the phase recorder on, each profile bucket holds the same
    stages with the same call counts, first-sighting counts and transfer
    bytes in both packages, and the recorder adds no readout sync. One
    difference is the port's design: its chunk programs launch the decode
    kernel through `decode_updates_v1`, so on the overlap lanes
    ``decode.v1`` records one call a chunk (beside the chunk stage, not
    inside it), where the JAX package's one chunk program holds the
    decode. On the serial lane the JAX run's XLA chunk step counts no
    transfer, and the port's kernel step counts its packed stream as the
    JAX package's fused step does. (`jax_runs` has compiled the JAX lanes
    already.)"""
    log, _, _ = _workload()
    yb, jax = _stages_by_bucket("ytpu", lambda lg: _jax(lg, **LANES[lane]), log)
    tb, port = _stages_by_bucket("ytpu_torch", lambda lg: _port(lg, **LANES[lane]), log)
    if lane != "serial":
        calls, first, h2d, _ = tb["device"].pop("decode.v1")
        assert calls == port.stats.chunks and first == 1 and h2d > 0
    else:
        calls, first, h2d, _ = tb["device"]["replay.chunk_fused"]
        assert yb["device"]["replay.chunk_fused"] == (calls, first, 0, 0) and h2d > 0
        tb["device"]["replay.chunk_fused"] = yb["device"]["replay.chunk_fused"]
    assert tb == yb
    assert port.stats.syncs == jax.stats.syncs == jax_runs[lane][0].stats.syncs
    assert tb["device"]["compact.packed"][0] == port.stats.compactions >= 1
