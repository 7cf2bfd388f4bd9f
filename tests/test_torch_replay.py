"""The port's replay slice end to end on the CPU: plan -> staged raw chunks
-> decode -> integrate -> compaction/growth -> readout -> text, against
the JAX package's FusedReplay (XLA lane, raw ingest, overlap pipeline) and
the host oracle, on the first 3,000 updates of the B4 log at 4 docs,
capacity 1,024, chunks of 512 (so compaction and growth both fire).
"""

import gzip
import os
import pickle

import numpy as np
import pytest
import torch

from ytpu.core import Doc
from ytpu.models import replay as jreplay
from ytpu.native import available as native_available
from ytpu.ops import integrate_kernel as jik

from ytpu_torch.convert import packed_from_numpy
from ytpu_torch.models import replay as treplay
from ytpu_torch.models.batch_doc import get_string
from ytpu_torch.ops import integrate_kernel as tik

from test_torch_integrate import AGREED_META, OS, assert_meta, assert_planes

# one intra-op thread: these cases are op-bound, and the suite runs
# several test processes side by side
torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not native_available(), reason="native codec unavailable (JAX plan pre-scan)")

N_UPDATES, N_DOCS, CAPACITY, CHUNK = 3000, 4, 1024, 512
SNAP_CHUNK = 3  # the JAX state after this many chunks seeds the port


def b4_log():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benches", "data", "b4_log.pkl.gz")
    with gzip.open(path, "rb") as f:
        return pickle.load(f)["log"][:N_UPDATES]


def host_text(log):
    doc = Doc()
    for p in log:
        doc.apply_update_v1(p)
    return doc.get_text("text").get_string()


@pytest.fixture(scope="module")
def runs():
    """One replay per package, recording each chunk's readout (the newest
    pending readout right after `step_raw`, before any drain) and the JAX
    driver's state after SNAP_CHUNK chunks."""
    log = b4_log()
    records = {"jax": [], "port": [], "snap": None, "occupied": []}
    j_step, t_step = jik.PackedReplayDriver.step_raw, tik.PackedReplayDriver.step_raw
    t_integrate = tik.integrate_stream

    def j_rec(self, *a, **k):
        out = j_step(self, *a, **k)
        records["jax"].append(np.array(self._pending[-1]))
        if len(records["jax"]) == SNAP_CHUNK:
            # np.array copies: the next chunk donates (reuses) these buffers
            records["snap"] = (np.array(self.cols), np.array(self.meta))
        return out

    def t_rec(self, *a, **k):
        out = t_step(self, *a, **k)
        records["port"].append(self._pending[-1].numpy().copy())
        return out

    def t_integrate_rec(cols, meta, *a, **k):
        before = int(meta[:, tik.M_NBLOCKS].sum())
        out = t_integrate(cols, meta, *a, **k)
        records["occupied"].append((before, int(meta[:, tik.M_NBLOCKS].sum())))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jik.PackedReplayDriver, "step_raw", j_rec)
    mp.setattr(tik.PackedReplayDriver, "step_raw", t_rec)
    mp.setattr(tik, "integrate_stream", t_integrate_rec)
    try:
        jr = jreplay.FusedReplay(
            n_docs=N_DOCS, plan=jreplay.plan_replay(log), capacity=CAPACITY, chunk=CHUNK,
            lane="xla", ingest="raw", overlap=True,
        )
        jr.run(log)
        tr = treplay.FusedReplay(N_DOCS, treplay.plan_replay(log), capacity=CAPACITY,
                                 chunk=CHUNK, device="cpu")
        tr.run(log)
    finally:
        mp.undo()
    return log, jr, tr, records


def test_plan_replay_matches():
    log = b4_log()
    j, t = jreplay.plan_replay(log), treplay.plan_replay(log)
    for name in ("n_updates", "max_rows", "max_dels", "max_len", "max_steps",
                 "max_sections", "max_client", "arena"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("unit_refs", "unit_byte", "adds"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert vars(treplay.plan_chunks(t.adds, 4096)) == vars(jreplay.plan_chunks(j.adds, 4096))
    wire, offs = treplay.build_wire_table(log)
    jw, jo = jreplay.build_wire_table(log)
    np.testing.assert_array_equal(wire, jw)
    np.testing.assert_array_equal(offs, jo)
    assert treplay.raw_chunk_cap(offs, CHUNK) == jreplay.raw_chunk_cap(jo, CHUNK)


def test_final_state_and_text_match(runs):
    log, jr, tr, _ = runs
    assert tr.stats.chunks == jr.stats.chunks == -(-N_UPDATES // CHUNK)
    assert tr.stats.compactions == jr.stats.compactions >= 1
    assert tr.stats.growths == jr.stats.growths >= 1
    j_cols, j_meta = np.asarray(jr.cols), np.asarray(jr.meta)
    t_cols, t_meta = tr.cols.numpy(), tr.meta.numpy()
    assert t_cols.shape == j_cols.shape
    assert_planes(t_cols, j_cols, skip=(OS,))
    assert_meta(t_meta, j_meta, AGREED_META)
    expect = host_text(log)
    view = treplay.UnitArenaView(tr.plan.unit_byte, tr.plan.arena)
    state = tik.unpack_state(tr.cols, tr.meta)
    for d in (0, N_DOCS - 1):
        assert tr.get_string(d) == expect
        assert jr.get_string(d) == expect
        assert get_string(state, d, view) == expect


def test_chunk_readouts_match(runs):
    _, _, tr, records = runs
    assert len(records["port"]) == len(records["jax"]) == tr.stats.chunks
    for k, (a, b) in enumerate(zip(records["port"], records["jax"])):
        assert a.shape == (tik.N_READOUT,) == b.shape
        np.testing.assert_array_equal(a, b, err_msg=f"chunk {k}")


def test_launch_rows_count_rows_before_and_after_each_launch(runs):
    """`stats.launch_rows_read` and `launch_rows_added`, taken from the
    lazy readouts, equal the occupied rows before every integrate launch
    and the rows each launch added."""
    _, _, tr, records = runs
    assert len(records["occupied"]) == tr.stats.chunks
    assert tr.stats.launch_rows_read == sum(b for b, _ in records["occupied"]) > 0
    assert tr.stats.launch_rows_added == sum(a - b for b, a in records["occupied"]) > 0


def test_chunk_phases_are_profiler_spans():
    """Every chunk records its decode / integrate / readout span (the decode
    call's own span inside the first) and every compaction and growth its
    own, so a trace splits the replay by phase."""
    log = b4_log()[:96]
    rep = treplay.FusedReplay(2, treplay.plan_replay(log), capacity=64, chunk=32, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rep.run(log)
    counts = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("ytpu_torch."):
            counts[e.name()] = counts.get(e.name(), 0) + 1
    st = rep.stats
    assert st.chunks == 3 and st.compactions >= 1 and st.growths >= 1
    assert counts == {
        "ytpu_torch.decode": st.chunks, "ytpu_torch.decode.v1": st.chunks, "ytpu_torch.integrate": st.chunks,
        "ytpu_torch.readout": st.chunks, "ytpu_torch.compaction": st.compactions,
        "ytpu_torch.grow": st.growths,
    }


def test_port_finishes_from_jax_midreplay_state(runs):
    """The JAX driver's state after SNAP_CHUNK chunks, carried over with
    `convert`, finishes the stream on the port's driver."""
    log, jr, tr, records = runs
    cols, meta = records["snap"]
    # a fresh driver starts from the state's actual occupancy (what the
    # JAX driver reads from its pending readouts before deciding to compact)
    driver = tik.PackedReplayDriver(
        *packed_from_numpy(cols, meta, "cpu"), tr._resolve_rank(None), unit_refs=True,
        gc_ranges=True, max_capacity=1 << 17,
        initial_occupancy=int(meta[:, tik.M_NBLOCKS].max()),
    )
    width = tr.plan.max_len + 16
    for k, slot in enumerate(tr.stage_chunks(log)):
        if k < SNAP_CHUNK:
            continue
        margin = int(tr.plan.adds[slot.pos : slot.end].sum()) + 8
        driver.step_raw(slot.raw, slot.offs, slot.lens, slot.refs, tr.dims(), width, margin=margin)
    t_cols, t_meta = (a.numpy() for a in driver.finish())
    assert_planes(t_cols, np.asarray(jr.cols), skip=(OS,))
    assert_meta(t_meta, np.asarray(jr.meta), AGREED_META)
