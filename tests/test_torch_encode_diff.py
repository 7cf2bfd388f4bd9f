"""The port's read path against the JAX package on the CPU:
`encode_diff_batch`'s four outputs, the wire bytes of `finish_encode_diff`
and `finish_encode_diff_batch` (repeated docs, another root name), and
`DiffPipeline` against the serial finisher at two (sub_batch, depth)
settings, on the sync cases (text, map, nested, moves), the cases of
ytpu's tests/test_encode_diff_batch.py and tests/test_batch_map.py, each
against an empty, a seeded and a caught-up remote state vector; and on
the port's own replay of a short B4 prefix, whose full diff must rebuild
the prefix's text in ytpu's host `Doc`. Tolerance: none, outputs are
integer tensors and bytes and must be equal."""

import gzip
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ytpu.core import Doc, Update
from ytpu.models import batch_doc as jbd

from ytpu_torch.models import batch_doc as tbd
from ytpu_torch.models import replay as treplay

from _torch_sync_cases import (
    CAPACITY, DELS, N_DOCS, ROWS, batch_steps, capture, doc_logs, port_tables, to_port_state,
)

torch.set_num_threads(1)

SELECTION = [3, 0, 1, 2, 0]  # a repeat, and not in doc order
PIPELINE_SETTINGS = [(1, 1), (2, 2)]


def typed_logs(edit_lists):
    """tests/test_encode_diff_batch.py's docs: client i+1 types its chunks."""
    logs = []
    for i, edits in enumerate(edit_lists):
        d = Doc(client_id=i + 1)
        log = capture(d)
        t = d.get_text("text")
        for pos, chunk in edits:
            with d.transact() as txn:
                t.insert(txn, pos, chunk)
        logs.append(log)
    return logs


def map_logs():
    """tests/test_batch_map.py's docs, each as one full-state update: set
    and overwrite, remove, and the two replicas of a concurrent write."""
    basic = Doc(client_id=1)
    with basic.transact() as txn:
        basic.get_map("m").insert(txn, "a", 1)
        basic.get_map("m").insert(txn, "b", "two")
    with basic.transact() as txn:
        basic.get_map("m").insert(txn, "a", 111)
    removed = Doc(client_id=1)
    with removed.transact() as txn:
        removed.get_map("m").insert(txn, "keep", 1)
        removed.get_map("m").insert(txn, "drop", 2)
    with removed.transact() as txn:
        removed.get_map("m").remove(txn, "drop")
    a, b = Doc(client_id=10), Doc(client_id=20)
    for d, v in ((a, "from-a"), (b, "from-b")):
        with d.transact() as txn:
            d.get_map("m").insert(txn, "k", v)
    ua, ub = a.encode_state_as_update_v1(), b.encode_state_as_update_v1()
    a.apply_update_v1(ub)
    b.apply_update_v1(ua)
    return [[d.encode_state_as_update_v1()] for d in (basic, removed, a, b)]


CASES = {
    "sync": (doc_logs, "text"),
    "typed": (lambda: typed_logs([[(0, "hello"), (5, " world")], [(0, "doc-two")],
                                  [(0, "abc"), (0, "xyz")], [(0, "dddd"), (0, "!")]]), "text"),
    "map": (map_logs, "m"),
}
REMOTES = ["empty", "seeded", "caught_up"]


@pytest.fixture(scope="module")
def states():
    """Per case: the JAX state (ytpu's `apply_update_batch`, one program for
    every case), the same state as port tensors, the encoder and the
    port's copy of its tables."""
    out = {}
    for name, (make, root) in CASES.items():
        logs = make()
        steps, enc = batch_steps(logs) if root == "text" else _steps(logs, root)
        rank = enc.interner.rank_table()
        js = jbd.init_state(N_DOCS, CAPACITY)
        for batch in steps:
            js = jbd.apply_update_batch(js, batch, rank)
        assert int(np.array(js.error).max()) == 0
        out[name] = (js, to_port_state(js), enc, port_tables(enc))
    return out


def _steps(logs, root):
    enc = jbd.BatchEncoder(root_name=root)
    steps = []
    for t in range(max(len(lg) for lg in logs)):
        ups = [Update.decode_v1(lg[t]) if t < len(lg) else None for lg in logs]
        steps.append(enc.build_batch(ups, n_rows=ROWS, n_dels=DELS))
    return steps, enc


def remote_sv(state, n, kind):
    if kind == "empty":
        return np.zeros((N_DOCS, n), dtype=np.int32)
    if kind == "seeded":
        return np.random.default_rng(5).integers(0, 6, size=(N_DOCS, n)).astype(np.int32)
    return tbd.state_vectors(state, n).numpy()


def selections(states, case, remote):
    js, ts, enc, tables = states[case]
    n = max(8, len(enc.interner))
    sv = remote_sv(ts, n, remote)
    want = [np.array(a) for a in jbd.encode_diff_batch(js, jnp.asarray(sv), n)]
    got = tbd.encode_diff_batch(ts, torch.from_numpy(sv), n)
    return want, got


@pytest.mark.parametrize("remote", REMOTES)
@pytest.mark.parametrize("case", list(CASES))
def test_encode_diff_batch_matches_jax(states, case, remote):
    want, got = selections(states, case, remote)
    for w, g in zip(want, got):
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
    ship = got[0]
    if remote == "empty":
        assert bool(ship.any(dim=1).all())
    if remote == "caught_up":
        assert not bool(ship.any())


@pytest.mark.parametrize("remote", REMOTES)
@pytest.mark.parametrize("case", list(CASES))
def test_finish_encode_diff_matches_jax(states, case, remote):
    js, ts, enc, tables = states[case]
    (ship, off, _, dele), got = selections(states, case, remote)
    for d in range(N_DOCS):
        want = jbd.finish_encode_diff(js, d, ship, off, dele, enc)
        assert tbd.finish_encode_diff(ts, d, got[0], got[1], got[3], tables) == want
        Update.decode_v1(want)  # the bytes are a v1 update


@pytest.mark.parametrize("root_name", [None, "other"])
@pytest.mark.parametrize("case", list(CASES))
def test_finish_encode_diff_batch_matches_jax(states, case, root_name):
    js, ts, enc, tables = states[case]
    (ship, off, _, dele), got = selections(states, case, "seeded")
    want = jbd.finish_encode_diff_batch(js, SELECTION, ship, off, dele, enc, root_name=root_name)
    if root_name is not None:
        tables = port_tables(enc, root_name)  # the port takes the root name from its tables
    port = tbd.finish_encode_diff_batch(ts, SELECTION, got[0], got[1], got[3], tables)
    assert port == want
    assert port[1] == port[4]


@pytest.mark.parametrize("sub_batch,depth", PIPELINE_SETTINGS)
@pytest.mark.parametrize("case", list(CASES))
def test_diff_pipeline_matches_serial(states, case, sub_batch, depth):
    _, ts, _, tables = states[case]
    _, got = selections(states, case, "empty")
    args = (ts, SELECTION, got[0], got[1], got[3], tables)
    serial = tbd.finish_encode_diff_batch(*args)
    pipe = tbd.DiffPipeline(sub_batch=sub_batch, depth=depth)
    assert pipe.run(*args) == serial
    st, plan = pipe.stats, pipe.plan(len(SELECTION))
    assert (st.sub, st.n_sub) == (plan.sub, plan.n_sub) == (sub_batch, -(-len(SELECTION) // sub_batch))
    assert st.syncs == st.n_sub + 1  # the counts, then one wait per sub-batch
    assert st.max_inflight == min(depth, st.n_sub)
    assert st.d2h_bytes == st.n_sub * st.sub * tbd.FINISH_PLANES * st.R * 4
    assert st.total_rows >= sum(int(got[0][d].sum()) for d in SELECTION)


@pytest.mark.parametrize("n_docs,sub_batch,depth", [(5, 2, 2), (1000, 512, 3), (3, 512, 2), (0, 4, 2)])
def test_plan_diff_pipeline_matches_jax(n_docs, sub_batch, depth):
    want = jbd.plan_diff_pipeline(n_docs, sub_batch, depth)
    got = tbd.plan_diff_pipeline(n_docs, sub_batch, depth)
    assert (got.n_docs, got.sub, got.n_sub, got.depth) == (want.n_docs, want.sub, want.n_sub, want.depth)
    assert got.host_buffers == min(depth, got.n_sub)


def test_doc_selection_out_of_range_raises(states):
    _, ts, _, tables = states["typed"]
    ship = torch.zeros((N_DOCS, CAPACITY), dtype=torch.bool)
    with pytest.raises(IndexError):
        tbd.finish_encode_diff_batch(ts, [0, N_DOCS], ship, ship.int(), ship, tables)
    with pytest.raises(IndexError):
        tbd.DiffPipeline(2, 2).run(ts, [-1], ship, ship.int(), ship, tables)


B4_UPDATES, B4_DOCS, B4_CAPACITY, B4_CHUNK = 300, 2, 1024, 128


@pytest.fixture(scope="module")
def b4_prefix():
    """The port's replay of the first B4 updates, its finisher tables (raw
    client ids, text through the unit arena) and the prefix's host text."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benches", "data", "b4_log.pkl.gz")
    with gzip.open(path, "rb") as f:
        log = pickle.load(f)["log"][:B4_UPDATES]
    rep = treplay.FusedReplay(B4_DOCS, treplay.plan_replay(log), capacity=B4_CAPACITY,
                              chunk=B4_CHUNK, device="cpu")
    rep.run(log)
    from ytpu_torch.ops.integrate_kernel import unpack_state

    host = Doc()
    for p in log:
        host.apply_update_v1(p)
    return unpack_state(rep.cols, rep.meta), tbd.EncoderTables.from_replay(rep), host


@pytest.mark.parametrize("remote", ["empty", "mid"])
def test_b4_prefix_diff_matches_jax(b4_prefix, remote):
    state, tables, host = b4_prefix
    n = len(tables.interner)
    sv = np.zeros((B4_DOCS, n), dtype=np.int32)
    if remote == "mid":
        sv[:] = tbd.state_vectors(state, n).numpy() // 2
    ship, off, local_sv, dele = tbd.encode_diff_batch(state, torch.from_numpy(sv), n)
    js = jbd.DocStateBatch(jbd.BlockCols(*(jnp.asarray(a.numpy()) for a in state.blocks)),
                           *(jnp.asarray(a.numpy()) for a in (state.start, state.n_blocks, state.error)))
    want_sel = [np.array(a) for a in jbd.encode_diff_batch(js, jnp.asarray(sv), n)]
    assert all(np.array_equal(g.numpy(), w) for g, w in zip((ship, off, local_sv, dele), want_sel))
    got = tbd.finish_encode_diff_batch(state, [0, 1], ship, off, dele, tables)
    # ytpu's Python finisher reads the same duck-typed tables
    want = [jbd.finish_encode_diff(js, d, *want_sel[:2], want_sel[3], tables) for d in range(B4_DOCS)]
    assert got == want and got[0] == got[1]
    assert tbd.DiffPipeline(1, 2).run(state, [0, 1], ship, off, dele, tables) == got
    if remote == "empty":
        replica = Doc(client_id=999)
        replica.apply_update_v1(got[0])
        assert replica.get_text("text").get_string() == host.get_text("text").get_string()
        for client, clock in host.state_vector().clocks.items():
            assert int(local_sv[0, client]) == clock


def test_config5_updates_equal_the_relay_log():
    """The seed of ytpu's ``bench_config5``: the bytes the relay doc
    observes equal the port's hand-written updates."""
    from ytpu_torch.benches.sync_step import config5_updates

    n = 64
    log = []
    relay = Doc(client_id=0xFFFF)
    relay.observe_update_v1(lambda p, o, t: log.append(p))
    for c in range(n):
        d = Doc(client_id=c + 1)
        with d.transact() as txn:
            d.get_text("text").insert(txn, 0, f"client-{c} ")
        relay.apply_update_v1(d.encode_state_as_update_v1(relay.state_vector()))
    assert config5_updates(n) == log


def test_stream_state_vector_and_lagged_batch():
    """The state vector of a decoded B4 prefix's first updates equals the
    host doc's after them; a lagged step gives each doc its own update."""
    from ytpu_torch.benches.sync_step import lagged_batch, stream_state_vector
    from ytpu_torch.ops import decode_kernel as tdk

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benches", "data", "b4_log.pkl.gz")
    with gzip.open(path, "rb") as f:
        log = pickle.load(f)["log"][:120]
    buf, lens = tdk.pack_updates(log)
    stream, _ = tdk.decode_updates_v1(torch.from_numpy(buf), torch.from_numpy(lens), max_rows=4, max_dels=4)
    host = Doc()
    for p in log[:90]:
        host.apply_update_v1(p)
    sv = stream_state_vector(stream, 90, 4)
    assert {c: int(sv[c]) for c in range(4) if int(sv[c])} == dict(host.state_vector().clocks)
    lag = torch.tensor([0, 5, 200])
    b = lagged_batch(stream, 7, lag)
    assert torch.equal(b.client[0], stream.client[7]) and torch.equal(b.clock[1], stream.clock[2])
    assert not bool(b.valid[2].any()) and not bool(b.del_valid[2].any())
