"""The port's host C++ wire finisher (`ytpu_torch.native` through
`batch_doc._FinisherContext`) on the CPU: `finish_encode_diff_batch` and
`DiffPipeline` byte for byte against ytpu's `finish_encode_diff_batch`
(its native finisher) and against the port's Python finisher
(`finish_encode_diff`, i.e. `_finish_rows`), with the library's statuses
equal to ytpu's. The shapes of ytpu's tests/test_native_finisher.py: full
and offset-trimmed text (a cut inside a surrogate pair), delete sets, map
and Any, rich text, wire-ref rows from the ingest fast lane, Any
canonicalisation, multi-client order. Besides: a call above
`FINISHER_MT_MIN_ROWS` rows equals the same call on one thread; a
`ChunkedWirePayloads` whose last chunk was dropped and replaced gives the
new chunk's bytes; `RawPayloadView` tables take the Python finisher for
every doc, counted in `fallback_docs`. Tolerance: none, bytes must be
equal."""

import struct
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ytpu.native as ytpu_native
from ytpu.core import Doc, StateVector, Update
from ytpu.encoding.lib0 import Writer
from ytpu.models import batch_doc as jbd
from ytpu.ops.decode_kernel import ChunkedWirePayloads as JaxChunkedWirePayloads
from ytpu.types.shared import MapPrelim

from ytpu_torch.benches.sync_step import config5_updates, wire_chunk_tables
from ytpu_torch.models import batch_doc as tbd
from ytpu_torch.models.ingest import BatchIngestor
from ytpu_torch.ops.decode_kernel import RawPayloadView, decode_updates_v1, identity_rank, pack_updates

from _torch_sync_cases import CAPACITY, DELS, N_DOCS, ROWS, capture, port_tables, to_jax_state, to_port_state

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def ytpu_native_lib():
    """ytpu's native library, loaded again if this worker lost a build race
    with another (it builds straight to its final path)."""
    for _ in range(5):
        if ytpu_native.load() is not None:
            return
        ytpu_native._tried = False
        time.sleep(1.0)
    pytest.fail("ytpu's native library did not load")


def _states(edit_fns, root="text"):
    """ytpu host docs (client i+1 runs edit_fns[i]), their logs applied step
    by step by ytpu's `BatchEncoder` to N_DOCS docs: ``(host docs, ytpu
    state, port state, ytpu encoder, port tables)``."""
    docs, logs = [], []
    for i, fn in enumerate(edit_fns):
        d = Doc(client_id=i + 1)
        logs.append(capture(d))
        fn(d)
        docs.append(d)
    enc = jbd.BatchEncoder(root_name=root)
    js = jbd.init_state(N_DOCS, CAPACITY)
    for t in range(max(len(lg) for lg in logs)):
        ups = [Update.decode_v1(lg[t]) if t < len(lg) else None for lg in logs]
        ups += [None] * (N_DOCS - len(ups))
        js = jbd.apply_update_batch(js, enc.build_batch(ups, n_rows=ROWS, n_dels=DELS), enc.interner.rank_table())
    assert int(np.asarray(js.error).max()) == 0
    return docs, js, to_port_state(js), enc, port_tables(enc)


def _both(js, ts, jenc, tables, docs, remote, j_payloads=None):
    """ytpu's native bytes, the port's batch bytes (checked against its
    Python finisher and `DiffPipeline`) and the port's stats."""
    n = remote.shape[1]
    ship, off, _, dele = (np.array(a) for a in jbd.encode_diff_batch(js, jnp.asarray(remote), n))
    tship, toff, _, tdele = tbd.encode_diff_batch(ts, torch.from_numpy(remote), n)
    assert np.array_equal(tship.numpy(), ship) and np.array_equal(toff.numpy(), off)
    want = jbd.finish_encode_diff_batch(js, docs, ship, off, dele, jenc, j_payloads)
    want_status = list(jbd.LAST_FINISH_STATUSES)
    stats = tbd.DiffStats()
    got = tbd.finish_encode_diff_batch(ts, docs, tship, toff, tdele, tables, stats=stats)
    plain = [tbd.finish_encode_diff(ts, d, tship, toff, tdele, tables) for d in docs]
    assert got == want, [(g.hex(), w.hex()) for g, w in zip(got, want) if g != w]
    assert got == plain
    assert stats.statuses == want_status and stats.fallback_docs == sum(want_status)
    for sub_batch, depth in ((1, 2), (2, 1)):
        pipe = tbd.DiffPipeline(sub_batch, depth)
        assert pipe.run(ts, docs, tship, toff, tdele, tables) == got
        assert pipe.stats.statuses == want_status and pipe.stats.fallback_docs == stats.fallback_docs
    return got, stats


def _typing(chunks):
    def fn(d):
        t = d.get_text("text")
        for pos, chunk in chunks:
            with d.transact() as txn:
                t.insert(txn, pos, chunk)
    return fn


def test_text_full_state():
    docs, js, ts, enc, tables = _states([
        _typing([(0, "hello"), (5, " world")]),
        _typing([(0, "doc-two"), (3, "✓🙂")]),
        _typing([(0, "abc"), (0, "xyz"), (3, "mid")]),
    ])
    got, stats = _both(js, ts, enc, tables, [0, 1, 2], np.zeros((N_DOCS, 8), dtype=np.int32))
    assert stats.statuses == [0, 0, 0] and stats.threads == 1
    for d, payload in zip(docs, got):
        replica = Doc(client_id=99)
        replica.apply_update_v1(payload)
        assert replica.get_text("text").get_string() == d.get_text("text").get_string()


@pytest.mark.parametrize("cut", [1, 2, 3, 4])
def test_text_offset_trimmed(cut):
    """A remote at clock `cut` trims the first block; clock 3 falls inside
    the surrogate pair of the emoji."""
    _, js, ts, enc, tables = _states([_typing([(0, "ab🙂cd")])])
    remote = np.zeros((N_DOCS, 8), dtype=np.int32)
    remote[0, enc.interner.to_idx[1]] = cut
    _, stats = _both(js, ts, enc, tables, [0], remote)
    assert stats.statuses == [0]


def test_delete_set():
    def fn(d):
        t = d.get_text("text")
        with d.transact() as txn:
            t.insert(txn, 0, "0123456789")
        with d.transact() as txn:
            t.remove_range(txn, 2, 3)
        with d.transact() as txn:
            t.remove_range(txn, 4, 2)

    docs, js, ts, enc, tables = _states([fn])
    got, _ = _both(js, ts, enc, tables, [0], np.zeros((N_DOCS, 8), dtype=np.int32))
    replica = Doc(client_id=99)
    replica.apply_update_v1(got[0])
    assert replica.get_text("text").get_string() == docs[0].get_text("text").get_string()


def test_map_and_any():
    """Map rows (parent_sub keys), Any scalars and arrays, a binary and a
    nested map: host refs through the pre-baked arenas."""
    def fn(d):
        m = d.get_map("m")
        for key, value in (("name", "alice"), ("age", 31), ("raw", b"\x01\x02"),
                           ("flags", [True, None, 2.5, "s"]), ("nested", MapPrelim({"x": "y"}))):
            with d.transact() as txn:
                m.insert(txn, key, value)

    docs, js, ts, enc, tables = _states([fn], root="m")
    got, stats = _both(js, ts, enc, tables, [0], np.zeros((N_DOCS, 8), dtype=np.int32))
    assert stats.statuses == [0]
    replica = Doc(client_id=99)
    replica.apply_update_v1(got[0])
    assert replica.get_map("m").to_json() == docs[0].get_map("m").to_json()


def test_rich_text():
    """Format marks and an embed (host content blobs)."""
    def fn(d):
        t = d.get_text("text")
        with d.transact() as txn:
            t.insert(txn, 0, "plain ")
        with d.transact() as txn:
            t.insert_with_attributes(txn, 6, "bold", {"b": True})
        with d.transact() as txn:
            t.insert_embed(txn, 4, {"img": "x.png"})

    docs, js, ts, enc, tables = _states([fn])
    got, _ = _both(js, ts, enc, tables, [0], np.zeros((N_DOCS, 8), dtype=np.int32))
    replica = Doc(client_id=99)
    replica.apply_update_v1(got[0])
    assert replica.get_text("text").diff() == docs[0].get_text("text").diff()


def test_multi_client_order():
    """Three clients' concurrent inserts: client sections by real id
    descending, clocks ascending."""
    d1, d2, d3 = Doc(client_id=3), Doc(client_id=200), Doc(client_id=77)
    t1 = d1.get_text("text")
    with d1.transact() as txn:
        t1.insert(txn, 0, "base")
    for d in (d2, d3):
        d.apply_update_v1(d1.encode_state_as_update_v1(StateVector()))
    for d, s in ((d2, "X"), (d3, "Y")):
        with d.transact() as txn:
            d.get_text("text").insert(txn, 2, s)
    for d in (d2, d3):
        d1.apply_update_v1(d.encode_state_as_update_v1(d1.state_vector()))
    merged = d1.encode_state_as_update_v1(StateVector())
    _, js, ts, enc, tables = _states([lambda d: d.apply_update_v1(merged)])
    got, _ = _both(js, ts, enc, tables, [0], np.zeros((N_DOCS, 8), dtype=np.int32))
    replica = Doc(client_id=99)
    replica.apply_update_v1(got[0])
    assert replica.get_text("text").get_string() == t1.get_string()


def _ingested(logs):
    """The port's ingestor after `apply_bytes` of each step of `logs` (one
    log per doc, every update down the fast lane), its tables, and ytpu's
    view of the same rows: the state as JAX arrays and a ytpu
    `ChunkedWirePayloads` holding the same items and chunks (ytpu's
    finisher reads the port's tables' interners and root name)."""
    ing = BatchIngestor(len(logs), 128, device="cpu")
    for t in range(max(len(lg) for lg in logs)):
        ing.apply_bytes([lg[t] if t < len(lg) else None for lg in logs])
    assert ing.fast_docs == sum(len(lg) for lg in logs)
    store = jbd.PayloadStore()
    store.items = list(ing.payloads.store.items)
    jpayloads = JaxChunkedWirePayloads(store)
    for _, flat in ing.payloads._chunks:
        jpayloads.add_chunk(flat)
    tables = tbd.EncoderTables(ing.enc.interner, ing.enc.keys, ing.payloads, "text")
    return ing, tables, to_jax_state(ing.state), jpayloads


@pytest.mark.parametrize("cut", [0, 3, 8])
def test_wire_refs_from_the_fast_lane(cut):
    """Rows decoded from wire bytes carry refs into the ingestor's retained
    chunks; the remote's cut 8 lands inside the emoji of the second
    block."""
    doc = Doc(client_id=5)
    log = capture(doc)
    t = doc.get_text("text")
    for edit in (lambda txn: t.insert(txn, 0, "chunky"), lambda txn: t.insert(txn, 6, " refs 🙂π"),
                 lambda txn: t.remove_range(txn, 2, 3)):
        with doc.transact() as txn:
            edit(txn)
    ing, tables, js, jpayloads = _ingested([log, log])
    n = max(8, len(ing.enc.interner))
    remote = np.zeros((2, n), dtype=np.int32)
    remote[1, ing.enc.interner.to_idx[5]] = cut
    got, stats = _both(js, ing.state, tables, tables, [0, 1], remote, jpayloads)
    assert stats.statuses == [0, 0]
    fresh = Doc(client_id=77)
    fresh.apply_update_v1(got[0])
    assert fresh.get_text("text").get_string() == t.get_string()


def test_wire_any_canonicalisation():
    """Non-canonical Any values on the wire (FLOAT32 2.0, BIGINT 5) come
    out as Python's read_any -> write_any writes them."""
    w = Writer()
    for v in (1, 1, 99, 0):  # client sections, blocks, client, clock
        w.write_var_uint(v)
    w.write_u8(8)  # ContentAny, no origins, no parent_sub
    w.write_var_uint(1)
    w.write_string("text")
    w.write_var_uint(3)
    w.write_u8(124)
    w.write_raw(struct.pack(">f", 2.0))
    w.write_u8(122)
    w.write_raw(struct.pack(">q", 5))
    w.write_u8(124)
    w.write_raw(struct.pack(">f", 2.5))
    w.write_var_uint(0)
    ing, tables, js, jpayloads = _ingested([[w.to_bytes()], []])
    n = max(8, len(ing.enc.interner))
    got, stats = _both(js, ing.state, tables, tables, [0], np.zeros((2, n), dtype=np.int32), jpayloads)
    assert stats.statuses == [0]
    fresh = Doc(client_id=2)
    fresh.apply_update_v1(got[0])
    assert fresh.state_vector().get(99) == 3


def test_replaced_wire_chunk_gives_fresh_bytes():
    """The finisher caches the retained chunks' bytes; a dropped chunk
    replaced by another at the same base must be read anew."""
    def update(text):
        d = Doc(client_id=5)
        log = capture(d)
        with d.transact() as txn:
            d.get_text("text").insert(txn, 0, text)
        return log[0]

    old, new = update("hello"), update("jelly")
    assert len(old) == len(new)
    ing = BatchIngestor(1, 64, device="cpu")
    ing.apply_bytes([old])
    tables = tbd.EncoderTables(ing.enc.interner, ing.enc.keys, ing.payloads, "text")
    sel = tbd.encode_diff_batch(ing.state, torch.zeros((1, 8), dtype=torch.int32), 8)
    args = (ing.state, [0], sel[0], sel[1], sel[3], tables)
    first = tbd.finish_encode_diff_batch(*args)[0]
    assert b"hello" in first
    generation = ing.payloads.generation
    ing.payloads.drop_if_unreferenced(0)
    assert ing.payloads.generation == generation + 1
    assert ing.payloads.add_chunk(np.frombuffer(new, dtype=np.uint8)) == 0
    stats = tbd.DiffStats()
    second = tbd.finish_encode_diff_batch(*args, stats=stats)[0]
    assert b"jelly" in second and stats.statuses == [0]
    assert second == tbd.finish_encode_diff(*args[:1], 0, *args[2:])


@pytest.fixture(scope="module")
def config5():
    """BASELINE config 5's 64 one-insert updates decoded and applied to 72
    docs of 128 slots: the state from the wire matrix's refs and from refs
    rebased onto one `ChunkedWirePayloads` chunk, with their tables."""
    updates = config5_updates(64)
    buf, lens = pack_updates(updates)
    stream, flags = decode_updates_v1(torch.from_numpy(buf), torch.from_numpy(lens), max_rows=1, max_dels=1)
    assert not bool(flags.any())
    rank = identity_rank(256, "cpu")
    raw = tbd.apply_update_stream(tbd.init_state(72, 128, device="cpu"), stream, rank)
    chunked_stream, tables = wire_chunk_tables(updates, stream, buf.shape[1], 65)
    chunked = tbd.apply_update_stream(tbd.init_state(72, 128, device="cpu"), chunked_stream, rank)
    assert int(raw.error.max()) == 0 and int(chunked.error.max()) == 0
    return (raw, tbd.EncoderTables.identity(65, RawPayloadView(buf))), (chunked, tables)


def test_thread_pool_equals_one_thread(config5, monkeypatch):
    """72 docs x 64 shipped rows: 4,608 rows, above FINISHER_MT_MIN_ROWS,
    so the call runs on a thread pool; the same call on one thread, and the
    Python finisher, write the same bytes."""
    state, tables = config5[1]
    sel = tbd.encode_diff_batch(state, torch.zeros((72, 65), dtype=torch.int32), 65)
    docs = list(range(72))
    pool = tbd.DiffStats()
    got = tbd.finish_encode_diff_batch(state, docs, sel[0], sel[1], sel[3], tables, stats=pool)
    assert pool.total_rows == 72 * 64 > tbd.FINISHER_MT_MIN_ROWS and pool.threads == 0
    assert pool.statuses == [0] * 72 and pool.fallback_docs == 0
    monkeypatch.setattr(tbd, "FINISHER_MT_MIN_ROWS", 1 << 30)
    one = tbd.DiffStats()
    assert tbd.finish_encode_diff_batch(state, docs, sel[0], sel[1], sel[3], tables, stats=one) == got
    assert one.threads == 1
    assert got == [tbd.finish_encode_diff(state, d, sel[0], sel[1], sel[3], tables) for d in docs]


def test_raw_payload_view_takes_the_python_finisher(config5):
    """The wire matrix's view has no native route: every doc is the Python
    finisher's, counted in fallback_docs, and its bytes equal the native
    finisher's over the same rows rebased onto a chunk."""
    (raw, raw_tables), (chunked, tables) = config5
    remote = torch.from_numpy(np.random.default_rng(5).integers(0, 12, size=(72, 65)).astype(np.int32))
    docs = [0, 5, 71, 5]
    sel = tbd.encode_diff_batch(raw, remote, 65)
    stats = tbd.DiffStats()
    got = tbd.finish_encode_diff_batch(raw, docs, sel[0], sel[1], sel[3], raw_tables, stats=stats)
    assert stats.fallback_docs == len(docs) and stats.statuses == []
    assert got == [tbd.finish_encode_diff(raw, d, sel[0], sel[1], sel[3], raw_tables) for d in docs]
    pipe = tbd.DiffPipeline(2, 2)
    assert pipe.run(raw, docs, sel[0], sel[1], sel[3], raw_tables) == got and pipe.stats.fallback_docs == 4
    csel = tbd.encode_diff_batch(chunked, remote, 65)
    native = tbd.DiffStats()
    assert tbd.finish_encode_diff_batch(chunked, docs, csel[0], csel[1], csel[3], tables, stats=native) == got
    assert native.fallback_docs == 0 and native.statuses == [0] * 4
