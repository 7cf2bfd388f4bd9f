"""The port's write path against the JAX package's XLA lane on the CPU:
`apply_update_batch` (one update per doc per step: a two-client text, a
map, nested branches and moves, each doc its own history) compared after
every step, `apply_update_stream` / `apply_update_stream_raw` (state and
conflict-scan record) and `apply_update_stream_fused(refresh_cache=True)`.
Every `DocStateBatch` field is compared, error flags included, after
`ensure_origin_slot` (the port's kernel leaves the origin-slot plane
stale). Tolerance: none, the state is int32 and bool and must be equal.
All applies share one shape, so each JAX program compiles once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ytpu.core import Update
from ytpu.models import batch_doc as jbd

from ytpu_torch.models import batch_doc as tbd
from ytpu_torch.ops import integrate_kernel as tik

from _torch_sync_cases import (
    CAPACITY, DELS, N_DOCS, ROWS, batch_steps, doc_logs, field_diffs, to_port_batch,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batch_runs():
    """Both packages over the same per-doc steps; the fields that differ
    after each step, and the final states."""
    logs = doc_logs()
    steps, enc = batch_steps(logs)
    rank_j = enc.interner.rank_table()
    rank_t = torch.from_numpy(np.array(rank_j))
    js = jbd.init_state(N_DOCS, CAPACITY)
    ts = tbd.init_state(N_DOCS, CAPACITY, "cpu")
    diffs, inputs_kept = [], True
    for batch in steps:
        js = jbd.apply_update_batch(js, batch, rank_j)
        before = [t.clone() for t in ts.blocks] + [ts.n_blocks.clone()]
        out = tbd.apply_update_batch(ts, to_port_batch(batch), rank_t)
        inputs_kept &= all(torch.equal(a, b) for a, b in zip(before, list(ts.blocks) + [ts.n_blocks]))
        assert tbd.origin_slot_is_stale(out)
        ts = tbd.ensure_origin_slot(out)
        diffs.append(field_diffs(ts, js))
    return {"logs": logs, "enc": enc, "diffs": diffs, "jax": js, "port": ts, "inputs_kept": inputs_kept}


def test_apply_update_batch_matches_jax_after_every_step(batch_runs):
    assert len(batch_runs["diffs"]) == max(len(lg) for lg in batch_runs["logs"])
    assert all(not d for d in batch_runs["diffs"]), batch_runs["diffs"]


def test_apply_update_batch_integrates_every_doc(batch_runs):
    """Every doc grew, and no doc carries an error flag."""
    ts = batch_runs["port"]
    assert (ts.n_blocks >= 8).all() and (ts.error == 0).all()
    # the map doc holds map rows, the nested doc branch children, the move doc moves
    bl = ts.blocks
    assert bool((bl.key[1] >= 0).any()) and bool((bl.parent[2] >= 0).any())
    assert bool((bl.kind[3] == 11).any())


def test_apply_update_batch_leaves_its_input_as_it_was(batch_runs):
    assert batch_runs["inputs_kept"]


def test_integrate_batch_with_equal_rows_equals_the_stream_step():
    """Every doc given the same rows integrates as one step of the shared
    stream does."""
    from ytpu_torch.benches.streams import anchored_state, synthetic_stream

    rows, dels = map(torch.from_numpy, synthetic_stream(5, 3))
    rank = torch.arange(256, dtype=torch.int32)
    cols, meta = anchored_state(3, 128, "cpu")
    cb, mb = cols.clone(), meta.clone()
    for s in range(rows.shape[0]):
        tik.integrate_stream_reference(cols, meta, rows[s : s + 1], dels[s : s + 1], rank)
        tik.integrate_batch(cb, mb, rows[s].expand(3, -1, -1).contiguous(),
                            dels[s].expand(3, -1, -1).contiguous(), rank)
    assert torch.equal(cols, cb) and torch.equal(meta, mb)
    assert int(meta[:, tik.M_NBLOCKS].min()) > 5


def test_integrate_batch_refuses_a_doc_count_mismatch():
    cols, meta = tik.pack_state(tbd.init_state(2, 16, "cpu"))
    rows = torch.zeros((3, 1, 23), dtype=torch.int32)
    dels = torch.zeros((3, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="3 docs"):
        tik.integrate_batch(cols, meta, rows, dels, torch.zeros(8, dtype=torch.int32))


@pytest.fixture(scope="module")
def stream_runs():
    """The two-client text log as one stream broadcast to every doc:
    ytpu's XLA lane with its scan record (`apply_update_stream_raw`), and
    the port's three stream entry points."""
    log = doc_logs()[0]
    enc = jbd.BatchEncoder(root_name="text")
    stream = jbd.BatchEncoder.stack_steps([enc.build_step(Update.decode_v1(p), ROWS, DELS) for p in log])
    rank_j = enc.interner.rank_table()
    rank_t = torch.from_numpy(np.array(rank_j))
    j_state, j_hist = jbd.apply_update_stream_raw(jbd.init_state(N_DOCS, CAPACITY), stream, rank_j)
    t_stream = to_port_batch(stream)
    t_init = tbd.init_state(N_DOCS, CAPACITY, "cpu")
    t_raw, t_hist = tbd.apply_update_stream_raw(t_init, t_stream, rank_t)
    return {
        "jax": j_state, "jax_hist": np.array(j_hist),
        "raw": t_raw, "raw_hist": t_hist.numpy(),
        "stream": tbd.apply_update_stream(t_init, t_stream, rank_t),
        "fused": tik.apply_update_stream_fused(t_init, t_stream, rank_t, refresh_cache=True),
    }


@pytest.mark.parametrize("entry", ["raw", "stream"])
def test_apply_update_stream_matches_jax(stream_runs, entry):
    out = stream_runs[entry]
    assert tbd.origin_slot_is_stale(out)
    assert field_diffs(tbd.ensure_origin_slot(out), stream_runs["jax"]) == []
    assert int(out.n_blocks.min()) > 10


def test_apply_update_stream_raw_scan_record_matches_jax(stream_runs):
    assert stream_runs["raw_hist"].shape == (N_DOCS, tbd.SCAN_REC_WORDS)
    assert np.array_equal(stream_runs["raw_hist"], stream_runs["jax_hist"])
    assert stream_runs["raw_hist"][:, : tbd.SCAN_WIDTH_BUCKETS].sum() > 0


def test_apply_update_stream_fused_refresh_cache_matches_jax(stream_runs):
    """ytpu's fused lane with ``refresh_cache=True`` is its XLA lane's state
    (held equal by ytpu's own tests) with the plane rebuilt."""
    out = stream_runs["fused"]
    assert not tbd.origin_slot_is_stale(out)
    want = jbd.recompute_origin_slot(stream_runs["jax"])
    assert field_diffs(out, want) == []
    assert int((out.blocks.origin_slot >= 0).sum()) > 0
