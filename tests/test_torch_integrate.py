"""The port's integrate (`ytpu_torch.ops.integrate_kernel`) against the JAX
package on the CPU.

On CPU tensors `integrate_stream` runs its plain version,
`integrate_stream_reference`, so these cases hold the plain version to
(a) the Pallas kernel `_kernel` itself, run in interpret mode exactly as
tests/test_pallas_kernel.py runs it, on every plane and every meta word,
and (b) the JAX package's XLA integrate lane (`xla_chunk_step`) on a wider
set of streams. The CUDA kernel is held to the same plain version on the
card by chip_smoke.py. Every comparison is exact: the state is int32.
"""

import random
import string

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ytpu.core import Doc, Update
from ytpu.models.batch_doc import BatchEncoder
from ytpu.models.batch_doc import init_state as jax_init_state
from ytpu.ops import integrate_kernel as jik

from ytpu_torch.convert import packed_from_numpy, packed_to_numpy, stream_from_numpy
from ytpu_torch.models.batch_doc import init_state
from ytpu_torch.ops import integrate_kernel as tik

from _fused_interpret import run_or_skip

# one intra-op thread: these cases are op-bound, and the suite runs
# several test processes side by side
torch.set_num_threads(1)

OS = 25
# Meta words on which the JAX package's two integrate lanes agree, and on
# which the XLA-lane comparisons below therefore hold the port. It is
# every word: start, n_blocks, error, the move-dirty flag (both lanes
# leave it 0 after a chunk), the 14 scan-record words (the XLA lane folds
# the same per-doc two-tier accounting) and the zero padding.
# `test_interpret_and_xla_lanes_agree` establishes the set on a stream
# that exercises every word, so a lane change that broke it would fail
# there first. The OS plane is NOT compared against the XLA lane: the
# fused kernel leaves it stale while the XLA lane maintains it.
AGREED_META = tuple(range(tik.M_PAD))

# every case shares one shape: one interpret trace of the Pallas kernel and
# one compiled XLA-lane program per scan plan
XLA_D, XLA_C, XLA_S, XLA_U, XLA_R, XLA_K = 8, 64, 48, 4, 4, 64


# --- stream builders -------------------------------------------------------------


def capture(doc):
    log = []
    doc.observe_update_v1(lambda p, o, t: log.append(p))
    return log


def encode(log, rows=4, dels=4, root_name="text", pre_intern=0):
    """Host wire updates -> the JAX package's stacked UpdateBatch stream.
    `pre_intern` interns that many unused client ids first, so the real
    clients land at interned indices >= pre_intern."""
    enc = BatchEncoder(root_name=root_name)
    for i in range(pre_intern):
        enc.interner.intern(10_000_000 + i)
    steps = [enc.build_step(Update.decode_v1(p), rows, dels) for p in log]
    return BatchEncoder.stack_steps(steps), enc


def pad_stream(stream, S):
    """Pad a stacked stream to S steps with invalid steps."""
    n = stream.valid.shape[0]
    if n > S:
        raise ValueError(f"stream has {n} steps, more than {S}")
    if n == S:
        return stream

    def pad(a):
        tail = jnp.broadcast_to(a[-1:], (S - n,) + a.shape[1:])
        return jnp.concatenate([a, tail], axis=0)

    out = type(stream)(*(pad(a) for a in stream))
    return out._replace(
        valid=out.valid.at[n:].set(False), del_valid=out.del_valid.at[n:].set(False)
    )


def rank_of(enc, k):
    return np.asarray(enc.interner.rank_table(pad_to=max(k, 1 << (len(enc.interner) - 1).bit_length())))[:k]


def packed_numpy(stream):
    rows, dels = jik.pack_stream(stream)
    return np.asarray(rows), np.asarray(dels)


def empty_packed(n_docs, capacity):
    cols, meta = jik.pack_state(jax_init_state(n_docs, capacity))
    return np.asarray(cols), np.asarray(meta)


def run_port(cols, meta, rows, dels, rank, scan_plan=(32, 8)):
    c, m = packed_from_numpy(cols, meta, "cpu")
    r, d = stream_from_numpy(rows, dels, "cpu")
    tik.integrate_stream(c, m, r, d, torch.from_numpy(np.array(rank, np.int32)), scan_plan)
    return packed_to_numpy(c, m)


def run_xla(cols, meta, stream, rank, scan_plan=(32, 8)):
    c, m = jik.xla_chunk_step(
        jnp.array(cols), jnp.array(meta), stream, jnp.asarray(rank, jnp.int32), scan_plan
    )
    return np.asarray(c), np.asarray(m)


def assert_planes(a_cols, b_cols, skip=()):
    for p in range(26):
        if p in skip:
            continue
        np.testing.assert_array_equal(a_cols[p], b_cols[p], err_msg=f"plane {p}")


def assert_meta(a_meta, b_meta, words=AGREED_META):
    for w in words:
        np.testing.assert_array_equal(a_meta[:, w], b_meta[:, w], err_msg=f"meta word {w}")


# --- host edit scenarios --------------------------------------------------------------


def seq_edits(n_ops, seed, width=3):
    doc = Doc(client_id=1)
    log = capture(doc)
    rng = random.Random(seed)
    t = doc.get_text("text")
    for _ in range(n_ops):
        with doc.transact() as txn:
            n = len(t)
            if n > 5 and rng.random() < 0.35:
                pos = rng.randint(0, n - 2)
                t.remove_range(txn, pos, min(rng.randint(1, 3), n - pos))
            else:
                word = "".join(rng.choice(string.ascii_lowercase) for _ in range(width))
                t.insert(txn, rng.randint(0, n), word)
    return log, t.get_string()


def sequential_inserts():
    doc = Doc(client_id=1)
    log = capture(doc)
    t = doc.get_text("text")
    for chunk in ["hello ", "world", "!", " again", "?"]:
        with doc.transact() as txn:
            t.insert(txn, len(t), chunk)
    return log


def concurrent_clients():
    """Three clients insert at the same spot, both delivery orders mixed."""
    docs = [Doc(client_id=c) for c in (5, 3, 9)]
    logs = [capture(d) for d in docs]
    for d, text in zip(docs, ("AAA", "BB", "C")):
        with d.transact() as txn:
            d.get_text("text").insert(txn, 0, text)
    with docs[1].transact() as txn:
        docs[1].get_text("text").insert(txn, 1, "x")
    return logs[0] + logs[1] + logs[2]


def same_origin_storm(n_clients=40):
    """n clients each insert one char right after the same base char."""
    base = Doc(client_id=1)
    log = capture(base)
    with base.transact() as txn:
        base.get_text("text").insert(txn, 0, "AB")
    out = list(log)
    for c in range(2, n_clients + 2):
        d = Doc(client_id=c)
        for p in log:
            d.apply_update_v1(p)
        dl = capture(d)
        with d.transact() as txn:
            d.get_text("text").insert(txn, 1, chr(ord("a") + c % 26))
        out += dl
    return out


def map_lww():
    doc = Doc(client_id=1)
    log = capture(doc)
    m = doc.get_map("m")
    for k, v in (("a", "1"), ("b", "2"), ("a", "3")):
        with doc.transact() as txn:
            m.insert(txn, k, v)
    with doc.transact() as txn:
        m.remove(txn, "b")
    with doc.transact() as txn:
        m.insert(txn, "b", "4")
    other = Doc(client_id=2)
    for p in log:
        other.apply_update_v1(p)
    ol = capture(other)
    with other.transact() as txn:
        other.get_map("m").insert(txn, "a", "5")
    return log + ol


def nested_parents():
    from ytpu.types.shared import ArrayPrelim, MapPrelim

    doc = Doc(client_id=1)
    log = capture(doc)
    m = doc.get_map("m")
    with doc.transact() as txn:
        m.insert(txn, "list", ArrayPrelim(["x"]))
    with doc.transact() as txn:
        m.get("list").push_back(txn, "y")
    with doc.transact() as txn:
        m.get("list").insert(txn, 0, "w")
    with doc.transact() as txn:
        m.insert(txn, "meta", MapPrelim({"k": "v"}))
    return log


def moves():
    doc = Doc(client_id=1)
    log = capture(doc)
    arr = doc.get_array("a")
    with doc.transact() as txn:
        for i in range(6):
            arr.push_back(txn, i)
    with doc.transact() as txn:
        arr.move_to(txn, 0, 4)
    with doc.transact() as txn:
        arr.move_range_to(txn, 1, 2, 0)
    with doc.transact() as txn:
        arr.insert(txn, 2, "in")
    with doc.transact() as txn:
        arr.move_to(txn, 5, 1)
    with doc.transact() as txn:
        arr.remove_range(txn, 0, 1)
    return log


def map_nested_moves():
    """Map LWW, nested branches and move rows in one array-rooted stream."""
    from ytpu.types.shared import MapPrelim

    doc = Doc(client_id=1)
    log = capture(doc)
    arr = doc.get_array("a")
    with doc.transact() as txn:
        for i in range(5):
            arr.push_back(txn, i)
    with doc.transact() as txn:
        arr.insert(txn, 1, MapPrelim({"k": "v"}))
    with doc.transact() as txn:
        arr.get(1).insert(txn, "k", "w")
    with doc.transact() as txn:
        arr.get(1).insert(txn, "j", "x")
    with doc.transact() as txn:
        arr.move_to(txn, 0, 4)
    with doc.transact() as txn:
        arr.move_range_to(txn, 2, 3, 0)
    with doc.transact() as txn:
        arr.remove_range(txn, 3, 1)
    return log


# --- (a) the Pallas kernel in interpret mode ---------------------------------------

INTERP_D, INTERP_C, INTERP_S = XLA_D, XLA_C, XLA_S


def _interpret_case(name):
    if name == "seq_del":
        log, _ = seq_edits(14, seed=9)
        stream, enc = encode(log)
    else:
        stream, enc = encode(map_nested_moves(), root_name="a")
    stream = pad_stream(stream, INTERP_S)
    return stream, rank_of(enc, XLA_K)


@pytest.mark.parametrize("case", ["seq_del", "map_nested_move"])
def test_reference_matches_pallas_kernel(case):
    stream, rank = _interpret_case(case)
    from ytpu.ops.integrate_kernel import apply_update_stream_fused

    # the entry point tests/test_pallas_kernel.py runs (its unpacked state
    # carries all 26 planes, the OS plane as the kernel left it)...
    fused = run_or_skip(lambda: apply_update_stream_fused(
        jax_init_state(INTERP_D, INTERP_C), stream, jnp.asarray(rank), d_block=INTERP_D,
        interpret=True, refresh_cache=False,
    ))
    # ...and the same compiled kernel on the packed state, for every meta word
    cols0, meta0 = empty_packed(INTERP_D, INTERP_C)
    rows, dels = packed_numpy(stream)
    k_cols, k_meta = jik._run(
        jnp.array(cols0), jnp.array(meta0), (jnp.asarray(rows), jnp.asarray(dels), jnp.asarray(rank)),
        INTERP_D, True, 3, 4, 64, (32, 8),
    )
    k_cols, k_meta = np.asarray(k_cols), np.asarray(k_meta)
    f_cols, f_meta = (np.asarray(a) for a in jik.pack_state(fused))
    np.testing.assert_array_equal(f_cols, k_cols)

    p_cols, p_meta = run_port(cols0, meta0, rows, dels, rank)
    assert_planes(p_cols, k_cols)
    np.testing.assert_array_equal(p_meta, k_meta)
    assert int(k_meta[:, tik.M_NBLOCKS].max()) > 10


def test_interpret_and_xla_lanes_agree():
    """Establishes AGREED_META: the meta words (and planes other than OS)
    on which the fused kernel and the XLA lane agree, on the stream with
    map, nested and move rows and a conflict scan."""
    stream, rank = _interpret_case("map_nested_move")
    cols0, meta0 = empty_packed(INTERP_D, INTERP_C)
    rows, dels = packed_numpy(stream)
    k_cols, k_meta = run_or_skip(lambda: jik._run(
        jnp.array(cols0), jnp.array(meta0), (jnp.asarray(rows), jnp.asarray(dels), jnp.asarray(rank)),
        INTERP_D, True, 3, 4, 64, (32, 8),
    ))
    x_cols, x_meta = run_xla(cols0, meta0, stream, rank)
    assert_planes(np.asarray(k_cols), x_cols, skip=(OS,))
    agreed = tuple(w for w in range(tik.M_PAD) if np.array_equal(np.asarray(k_meta)[:, w], x_meta[:, w]))
    assert agreed == AGREED_META
    assert int(x_cols[tik.MV].max()) >= 0  # a move claimed rows


# --- (b) the XLA lane on a wider set of streams ------------------------------------


def scattered_inserts(n_txn=46, per_txn=4, seed=2):
    """Transactions of several single-char inserts at random positions:
    every insert splits a block, so the doc outgrows XLA_C slots."""
    doc = Doc(client_id=1)
    log = capture(doc)
    rng = random.Random(seed)
    t = doc.get_text("text")
    with doc.transact() as txn:
        t.insert(txn, 0, "abcdefgh")
    for _ in range(n_txn):
        with doc.transact() as txn:
            for _ in range(per_txn):
                t.insert(txn, rng.randint(1, len(t) - 1), rng.choice("xyz"))
    return log


def _xla_case(name):
    """(stream padded to the shared shape, rank [XLA_K], expected text or
    None, the encoder)."""
    root = "text"
    pre = 0
    expect = None
    if name == "sequential":
        log = sequential_inserts()
    elif name == "random_edits":
        log, expect = seq_edits(24, seed=4)
    elif name == "concurrent_rank_beyond_K":
        # the clients intern at indices >= XLA_K: every rank reads 0, so the
        # tie-break falls to the (client-rank, clock) order of gather_rank
        log = concurrent_clients()
        pre = XLA_K
    elif name == "concurrent":
        log = concurrent_clients()
    elif name == "map_lww":
        log = map_lww()
    elif name == "nested":
        log = nested_parents()
    elif name == "moves":
        log = moves()
        root = "a"
    elif name == "storm":
        log = same_origin_storm()
    elif name == "capacity_overflow":
        log = scattered_inserts()
    elif name == "missing_dependency":
        log, _ = seq_edits(12, seed=5)
        log = log[:3] + log[4:]  # one update never arrives
    else:
        raise ValueError(name)
    stream, enc = encode(log, XLA_U, XLA_R, root_name=root, pre_intern=pre)
    return pad_stream(stream, XLA_S), rank_of(enc, XLA_K), expect, enc


XLA_CASES = [
    "sequential", "random_edits", "concurrent", "concurrent_rank_beyond_K",
    "map_lww", "nested", "moves", "capacity_overflow", "missing_dependency",
]


@pytest.mark.parametrize("case", XLA_CASES)
def test_reference_matches_xla_lane(case):
    stream, rank, expect, enc = _xla_case(case)
    cols0, meta0 = empty_packed(XLA_D, XLA_C)
    rows, dels = packed_numpy(stream)
    x_cols, x_meta = run_xla(cols0, meta0, stream, rank)
    p_cols, p_meta = run_port(cols0, meta0, rows, dels, rank)
    assert_planes(p_cols, x_cols, skip=(OS,))
    assert_meta(p_meta, x_meta)
    err = int(p_meta[:, tik.M_ERROR].max())
    if case == "capacity_overflow":
        assert err & tik.ERR_CAPACITY
    elif case == "missing_dependency":
        assert err & tik.ERR_MISSING_DEP
    else:
        assert err == 0
    if case == "moves":
        assert int(p_cols[tik.MV].max()) >= 0
    if expect is not None:
        from ytpu_torch.models.batch_doc import get_string

        state = tik.unpack_state(*packed_from_numpy(p_cols, p_meta, "cpu"))
        assert get_string(state, 0, enc.payloads) == expect
        assert get_string(state, XLA_D - 1, enc.payloads) == expect


@pytest.mark.parametrize("scan_plan", [(32, 8), (0, 8), (4, 1)])
def test_scan_record_matches_xla_lane_at_scan_plans(scan_plan):
    """A same-origin storm drives conflict scans past each plan's cheap
    bound; the two-tier trip accounting must match word for word."""
    stream, rank, _, _ = _xla_case("storm")
    cols0, meta0 = empty_packed(XLA_D, XLA_C)
    rows, dels = packed_numpy(stream)
    x_cols, x_meta = run_xla(cols0, meta0, stream, rank, scan_plan)
    p_cols, p_meta = run_port(cols0, meta0, rows, dels, rank, scan_plan)
    assert_planes(p_cols, x_cols, skip=(OS,))
    assert_meta(p_meta, x_meta)
    assert int(p_meta[:, tik.M_SCANW_MAX].max()) > 8
    if scan_plan != (32, 8):
        assert int(p_meta[:, tik.M_TIER_WIDE].max()) > 0


# --- edge semantics of the packed-state access -------------------------------------


def _tiny_state():
    cols, meta = tik.pack_state(init_state(2, 8, "cpu"))
    return cols, meta


def test_gather_put_edges_through_split_overflow():
    """A split on a full doc sets ERR_CAPACITY and does not split; a doc
    with room splits, and the right half inherits MV with empty move-range
    planes."""
    cols, meta = _tiny_state()
    C = cols.shape[2]
    # doc 0: one 4-long block of client 1 at slot 0 owned by move slot 3,
    # with C - 1 filler rows (full); doc 1: the same block, room to split
    for d in (0, 1):
        cols[tik.CL, d, 0], cols[tik.CK, d, 0], cols[tik.LN, d, 0] = 1, 0, 4
        cols[tik.MV, d, 0] = 3
        cols[tik.MSC, d, 0] = 7  # a range plane the split must not copy
        cols[tik.CN, d, 0] = 1
        meta[d, tik.M_START] = 0
        meta[d, tik.M_NBLOCKS] = 1
    meta[0, tik.M_NBLOCKS] = C
    cols[tik.CL, 0, 1:] = 2
    cols[tik.LN, 0, 1:] = 1
    cols[tik.CK, 0, 1:] = torch.arange(C - 1, dtype=torch.int32)
    rows = torch.zeros((1, 1, 23), dtype=torch.int32)
    dels = torch.tensor([[[1, 1, 2, 1]]], dtype=torch.int32)  # delete clock 1 of client 1
    rank = torch.arange(4, dtype=torch.int32)
    tik.integrate_stream(cols, meta, rows, dels, rank)
    assert int(meta[0, tik.M_ERROR]) & tik.ERR_CAPACITY
    assert int(meta[0, tik.M_NBLOCKS]) == C and int(cols[tik.LN, 0, 0]) == 4
    assert int(meta[1, tik.M_ERROR]) == 0
    assert int(meta[1, tik.M_NBLOCKS]) == 3
    assert cols[tik.LN, 1, :3].tolist() == [1, 1, 2]
    assert cols[tik.DL, 1, :3].tolist() == [0, 1, 0]
    assert cols[tik.MV, 1, :3].tolist() == [3, 3, 3]
    assert cols[tik.MSC, 1, :3].tolist() == [7, -1, -1]


def test_rank_beyond_table_reads_zero_and_wrapper_checks():
    cols, meta = _tiny_state()
    rows = torch.zeros((1, 1, 23), dtype=torch.int32)
    dels = torch.zeros((1, 1, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        tik.integrate_stream(cols, meta, rows.long(), dels, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        tik.integrate_stream(cols, meta, rows[:, :, :20].contiguous(), dels, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        tik.integrate_stream(cols, meta, rows, dels, torch.zeros(4, dtype=torch.int32), (0, 0))
    # two concurrent root inserts: client 9 lies above the 4-entry rank
    # table and so ranks 0, below client 0's rank 5; the conflict scan of
    # client 0's row therefore takes client 9's row as its left neighbor
    r = torch.zeros((2, 1, 23), dtype=torch.int32)
    r[0, 0, :15] = torch.tensor([9, 0, 1, -1, 0, -1, 0, 4, 0, 0, -1, 1, -1, 0, 1])
    r[1, 0, :15] = torch.tensor([0, 0, 1, -1, 0, -1, 0, 4, 1, 0, -1, 1, -1, 0, 1])
    r[:, 0, 15:] = torch.tensor([-1, 0, 0, -1, 0, 0, -1, -1])
    d = torch.zeros((2, 1, 4), dtype=torch.int32)
    tik.integrate_stream(cols, meta, r, d, torch.tensor([5, 6, 7, 8], dtype=torch.int32))
    assert int(meta[0, tik.M_ERROR]) == 0 and int(meta[0, tik.M_NBLOCKS]) == 2
    # both rows scan (widths 0 and 1: bucket 0), one candidate visited
    assert int(meta[0, tik.M_HIST0]) == 2 and int(meta[0, tik.M_WIDTH_SUM]) == 1
    assert int(meta[0, tik.M_START]) == 0 and int(cols[tik.RT, 0, 0]) == 1
