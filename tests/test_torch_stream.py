"""The port's packed-stream entry points against the JAX package's on the
CPU: `replay_stream_fused` (chunked `PackedReplayDriver.step` with a padded
tail and between-chunk compaction) against ytpu's fused lane in interpret
mode, on a text log and a move log, and `RawPayloadView.slice_text` against
ytpu's on the same wire matrix. Both logs decode to one stream shape and
replay at one capacity, so they share one interpret trace of the Pallas
kernel. Every comparison is exact: the state is int32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ytpu.core import Doc
from ytpu.models.batch_doc import CompactionPolicy as JaxPolicy
from ytpu.models.batch_doc import get_string as jax_get_string
from ytpu.models.batch_doc import init_state as jax_init_state
from ytpu.ops import decode_kernel as jdk
from ytpu.ops import integrate_kernel as jik

from ytpu_torch.models.batch_doc import CompactionPolicy, get_string, init_state, origin_slot_is_stale
from ytpu_torch.ops import decode_kernel as tdk
from ytpu_torch.ops import integrate_kernel as tik

from _fused_interpret import run_or_skip
from test_torch_integrate import capture, seq_edits

torch.set_num_threads(1)

N_DOCS, CAPACITY, CHUNK_STEPS = 2, 256, 16
ROWS, DELS = 4, 4
# a low watermark, so that compaction fires inside these short logs
WATERMARK = 0.1


def move_log():
    """An array of strings with moves, a nested insert and removals."""
    doc = Doc(client_id=1)
    log = capture(doc)
    arr = doc.get_array("text")
    with doc.transact() as txn:
        for i in range(8):
            arr.insert(txn, i, f"e{i}")
    for i in range(30):
        with doc.transact() as txn:
            arr.move_to(txn, i % 5, (i * 3 + 2) % 8)
        if i % 4 == 3:
            with doc.transact() as txn:
                arr.remove_range(txn, i % 6, 1)
            with doc.transact() as txn:
                arr.insert(txn, 0, f"n{i}")
    return log, None


LOGS = {"text": lambda: seq_edits(90, seed=4), "moves": move_log}


def decode_port(log):
    buf_np, lens_np = tdk.pack_updates(log)
    stream, _ = tdk.decode_updates_v1(
        torch.from_numpy(buf_np), torch.from_numpy(lens_np), max_rows=ROWS, max_dels=DELS
    )
    return stream


def decode_both(log):
    buf_np, lens_np = jdk.pack_updates(log)
    j_stream, j_flags = jdk.decode_updates_v1(
        jnp.asarray(buf_np), jnp.asarray(lens_np), max_rows=ROWS, max_dels=DELS
    )
    t_stream, t_flags = tdk.decode_updates_v1(
        torch.from_numpy(buf_np), torch.from_numpy(lens_np), max_rows=ROWS, max_dels=DELS
    )
    assert not (np.asarray(j_flags) & jdk.FLAG_ERRORS).any()
    return buf_np, j_stream, t_stream


@pytest.mark.parametrize("name", list(LOGS))
def test_replay_stream_fused_matches_jax_interpret(name):
    log, expect = LOGS[name]()
    buf_np, j_stream, t_stream = decode_both(log)
    S = len(log)
    assert S % CHUNK_STEPS != 0  # the last window is padded
    j_state, j_stats = run_or_skip(lambda: jik.replay_stream_fused(
        jax_init_state(N_DOCS, CAPACITY), j_stream, jdk.identity_rank(256), chunk_steps=CHUNK_STEPS,
        d_block=N_DOCS, interpret=True, lane="fused", policy=JaxPolicy(high_watermark=WATERMARK),
        max_capacity=CAPACITY,
    ))
    t_state, t_stats = tik.replay_stream_fused(
        init_state(N_DOCS, CAPACITY, "cpu"), t_stream, tdk.identity_rank(256, "cpu"),
        chunk_steps=CHUNK_STEPS, policy=CompactionPolicy(high_watermark=WATERMARK),
        max_capacity=CAPACITY,
    )
    j_cols, j_meta = (np.array(a) for a in jik.pack_state(j_state))
    t_cols, t_meta = (a.numpy() for a in tik.pack_state(t_state))
    for p in range(tik.NC):
        if p != tik.OS:
            np.testing.assert_array_equal(t_cols[p], j_cols[p], err_msg=f"plane {p}")
    np.testing.assert_array_equal(t_meta[:, :4], j_meta[:, :4])
    assert int(t_meta[:, tik.M_ERROR].max()) == 0
    for field in ("chunks", "compactions", "growths", "peak_blocks", "final_blocks", "scan_hist",
                  "scan_max", "commit_word", "occupied_rows", "dead_rows", "reclaimed_rows"):
        assert getattr(t_stats, field) == getattr(j_stats, field), field
    assert t_stats.chunks == -(-S // CHUNK_STEPS) and t_stats.compactions >= 1
    assert origin_slot_is_stale(t_state)
    for d in range(N_DOCS):
        text = get_string(t_state, d, tdk.RawPayloadView(buf_np))
        assert text == jax_get_string(j_state, d, jdk.RawPayloadView(buf_np))
        if expect is not None:
            assert text == expect
    if name == "moves":
        assert (t_cols[tik.KD] == 11).any() and (t_cols[tik.MV] >= 0).any()


def test_step_reads_its_margin_from_the_stream():
    stream = decode_port(seq_edits(20, seed=2)[0])
    runs = []
    for margin in (None, 3 * ROWS * 20 + 2 * DELS * 20 + 8):
        cols, meta = tik.pack_state(init_state(N_DOCS, 512, "cpu"))
        driver = tik.PackedReplayDriver(cols, meta, tdk.identity_rank(256, "cpu"))
        driver.step(stream, margin=margin)
        runs.append(driver.finish())
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert driver.stats.chunks == 1 and driver.stats.syncs == 1


def test_empty_stream_returns_the_state():
    stream = decode_port(seq_edits(3, seed=1)[0])
    empty = type(stream)(*(a[:0] for a in stream))
    state = init_state(N_DOCS, 64, "cpu")
    out, stats = tik.replay_stream_fused(state, empty, tdk.identity_rank(256, "cpu"))
    assert out is state and stats.chunks == 0 and stats.capacity == 64


def test_raw_payload_view_matches():
    """Every (off, len) slice of multi-byte and surrogate-pair strings,
    including slices that start or end inside a pair."""
    doc = Doc(client_id=3)
    log = capture(doc)
    t = doc.get_text("text")
    for s in ("héllo 😀 wörld", "𝄞a€", "plain"):
        with doc.transact() as txn:
            t.insert(txn, len(t), s)
    buf_np, j_stream, t_stream = decode_both(log)
    j_view, t_view = jdk.RawPayloadView(buf_np), tdk.RawPayloadView(buf_np)
    refs = t_stream.content_ref[:, 0].tolist()
    lens = t_stream.length[:, 0].tolist()
    assert refs == np.asarray(j_stream.content_ref[:, 0]).tolist()
    n = 0
    for ref, length in zip(refs, lens):
        for off in range(length + 1):
            for ln in range(length - off + 1):
                assert t_view.slice_text(ref, off, ln) == j_view.slice_text(ref, off, ln)
                n += 1
    assert n > 100
    assert t_view.slice_text(refs[0], 0, lens[0]) == "héllo 😀 wörld"
    assert t_view.slice_text(refs[0], 7, 1) == "�"
