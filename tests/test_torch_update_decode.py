"""The port's update decoding against ytpu's on the CPU:

- the column walk `ytpu_torch.encoding.lib0.update_columns` against ytpu's
  native column decoder (`ytpu.native.decode_update_columns`), column by
  column, where that library loaded, and against ytpu's
  `Update.decode_v1` carriers where it did not;
- the host decode `ytpu_torch.core.update.Update.decode_v1` against
  ytpu's, carrier by carrier (ids, origins, parents, content and its wire
  encoding) and its delete set;
- `decode_updates_v1` with each intern table (clients, big-client hashes,
  map keys, primary roots): every column and every lane's flags equal to
  ytpu's, and each miss raising its flag;
- `decode_updates_v1` with no tables: the B4 and sync-step streams and the
  decode corpus give byte for byte the tensors they gave before the tables
  were added (digests recorded from that code), and ytpu's.
"""

import gzip
import hashlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from ytpu.core import Update as JaxUpdate  # noqa: E402
from ytpu.encoding.codec import EncoderV1 as JaxEncoderV1  # noqa: E402
from ytpu.encoding.lib0 import EncodingError as JaxEncodingError  # noqa: E402
from ytpu.native import available as native_available  # noqa: E402
from ytpu.native import decode_update_columns  # noqa: E402
from ytpu.ops import decode_kernel as jdk  # noqa: E402

import _torch_ingest_cases as cases  # noqa: E402
from ytpu_torch.core.ids import ID  # noqa: E402
from ytpu_torch.core.update import Update  # noqa: E402
from ytpu_torch.encoding.codec import EncoderV1  # noqa: E402
from ytpu_torch.encoding.lib0 import BLOCK_COLUMNS, DEL_COLUMNS, EncodingError, update_columns  # noqa: E402
from ytpu_torch.ops import decode_kernel as tdk  # noqa: E402

torch.set_num_threads(1)

CORPUS = cases.wire_corpus()
IDS = [f"p{i:02d}" for i in range(len(CORPUS))]
COUNTS = ("n_blocks", "n_dels", "n_client_sections", "n_ds_sections", "n_zero_len_blocks", "n_value_steps",
          "n_complex_any")


@pytest.mark.parametrize("i", range(len(CORPUS)), ids=IDS)
def test_update_columns_match_ytpu(i):
    p = CORPUS[i]
    py = update_columns(p)
    if native_available():
        nat = decode_update_columns(p)
        assert py.error == nat.error
        if nat.error:
            return  # the native walker keeps the block it failed in; both send the doc to the host
        for name in COUNTS:
            assert getattr(py, name) == getattr(nat, name), name
        for name in BLOCK_COLUMNS + DEL_COLUMNS:
            np.testing.assert_array_equal(getattr(py, name), getattr(nat, name), err_msg=name)
        for j in range(py.n_blocks):
            assert py.content_bytes(j) == nat.content_bytes(j)
            if int(py.parent_kind[j]) == 1:
                assert py.parent_name(j) == nat.parent_name(j)
            assert py.parent_sub(j) == nat.parent_sub(j)
        assert tdk.steps_for_columns(py) == jdk.steps_for_columns(nat)
        return
    try:
        u = JaxUpdate.decode_v1(p)
    except JaxEncodingError:
        assert py.error
        return
    carriers = [(c, b.id.clock, b.len) for c in u.blocks for b in u.blocks[c]]
    got = list(zip(py.client.tolist(), py.clock.tolist(), py.length.tolist()))
    assert sorted(got) == sorted(carriers)


def _content_bytes(content, enc):
    content.encode(enc)
    return enc.to_bytes()


def _parent(p):
    return (p.client, p.clock) if isinstance(p, tuple) else p


@pytest.mark.parametrize("i", range(len(CORPUS)), ids=IDS)
def test_host_decode_matches_ytpu(i):
    p = CORPUS[i]
    try:
        want = JaxUpdate.decode_v1(p)
    except JaxEncodingError:
        with pytest.raises(EncodingError):
            Update.decode_v1(p)
        return
    got = Update.decode_v1(p)
    assert list(got.blocks) == list(want.blocks)
    for c in want.blocks:
        assert len(got.blocks[c]) == len(want.blocks[c])
        for g, w in zip(got.blocks[c], want.blocks[c]):
            assert type(g).__name__ == type(w).__name__
            assert (g.id, g.len) == (ID(*w.id), w.len)
            if not w.is_item:
                continue
            assert g.origin == (None if w.origin is None else ID(*w.origin))
            assert g.right_origin == (None if w.right_origin is None else ID(*w.right_origin))
            assert _parent(g.parent) == _parent(w.parent)
            assert g.parent_sub == w.parent_sub
            assert g.content.kind == w.content.kind and g.countable == w.countable
            assert _content_bytes(g.content, EncoderV1()) == _content_bytes(w.content, JaxEncoderV1())
    assert got.delete_set.clients == want.delete_set.clients
    assert got.is_empty() == want.is_empty()
    assert got.state_vector().clocks == want.state_vector().clocks


def test_update_v2_is_not_ported():
    """A V2 update cut after its feature flag raises as the JAX package's
    V2 decode does (tests/test_torch_v2_codec.py holds whole V2 updates
    to it)."""
    with pytest.raises(JaxEncodingError):
        JaxUpdate.decode_v2(b"\x00")
    with pytest.raises(EncodingError):
        Update.decode_v2(b"\x00")


# --- decode with intern tables ------------------------------------------------------


def _tables(mapping):
    ks = sorted(mapping)
    vs = [mapping[k] for k in ks]
    return ((jnp.asarray(np.asarray(ks, np.int32)), jnp.asarray(np.asarray(vs, np.int32))),
            (torch.tensor(ks, dtype=torch.int32), torch.tensor(vs, dtype=torch.int32)))


def _table_payloads():
    """``(payloads, primary root names)``: map rows, three named roots
    ("body" primary), a 53-bit client, two clients, nested types and a
    root name beyond the hash window."""
    groups = [
        (cases.map_log()[0][:5], "m"),
        (cases.multi_root_log()[0], "body"),
        (cases.text_log([("i", 0, "big"), ("i", 3, " ids"), ("d", 0, 1)], client_id=cases.BIG)[0], "text"),
        ([cases.two_client_update()[0]], "text"),
        (cases.nested_log()[0][:3], "root"),
        (cases.text_log([("i", 0, "long")], root="r" * 40)[0], "r" * 40),
    ]
    return [p for ps, _ in groups for p in ps], [name for ps, name in groups for _ in ps]


TABLE_PAYLOADS, PRIMARY_ROOTS = _table_payloads()
CLIENTS = sorted({c for p in TABLE_PAYLOADS for c in update_columns(p).client.tolist()}
                 | {c for p in TABLE_PAYLOADS for c in update_columns(p).del_client.tolist()})
KEYS = ["name", "age", "flags", "flat", "score", "body", "title", "meta", "lang", "text", "sub", "list",
        "inner", "a", "r" * 40]


def _case_tables(case):
    """``(client_table, key_table, client_hash_table, primary_root_hash)``
    mappings of one case; None = no table."""
    small = [c for c in CLIENTS if c <= 2**31 - 1]
    big = [c for c in CLIENTS if c > 2**31 - 1]
    interned = {c: i for i, c in enumerate(reversed(CLIENTS))}
    keys = {tdk.key_hash_host(k.encode()): i for i, k in enumerate(KEYS)}
    hashes = {tdk.client_hash_host(c): interned[c] for c in big}
    prim = [tdk.key_hash_host(name.encode()) for name in PRIMARY_ROOTS]
    all_small = {c: interned[c] for c in small}
    return {
        "all": (all_small, keys, hashes, prim),
        "client_miss": ({c: i for c, i in all_small.items() if c != small[0]}, keys, hashes, prim),
        "empty_client_table": ({}, keys, hashes, prim),
        "no_hash_table": (all_small, keys, None, prim),
        "hash_miss": (all_small, keys, {h + 1: i for h, i in hashes.items()}, prim),
        "no_key_table": (all_small, None, hashes, prim),
        "key_miss": (all_small, {h: i for h, i in keys.items() if h != tdk.key_hash_host(b"age")}, hashes, prim),
        "root_miss": (all_small, {h: i for h, i in keys.items() if h != tdk.key_hash_host(b"title")}, hashes, prim),
        "no_primary": (all_small, keys, hashes, None),
    }[case]


# the flag each case must raise somewhere (0: none)
TABLE_CASES = {
    "all": tdk.FLAG_UNSUPPORTED,  # only the root name beyond the hash window
    "client_miss": tdk.FLAG_UNKNOWN_CLIENT,
    "empty_client_table": tdk.FLAG_UNKNOWN_CLIENT,
    "no_hash_table": tdk.FLAG_BIG_CLIENT,
    "hash_miss": tdk.FLAG_UNKNOWN_CLIENT,
    "no_key_table": tdk.FLAG_UNKNOWN_KEY,
    "key_miss": tdk.FLAG_UNKNOWN_KEY,
    "root_miss": tdk.FLAG_UNKNOWN_KEY,
    "no_primary": 0,
}


def _decode_pair(payloads, tables):
    ct, kt, ht, prim = tables
    buf, lens = jdk.pack_updates(payloads)
    dims = dict(max_rows=8, max_dels=4, n_steps=160, max_sections=4)
    jt = {k: (None if m is None else _tables(m)[0]) for k, m in
          (("client_table", ct), ("key_table", kt), ("client_hash_table", ht))}
    tt = {k: (None if m is None else _tables(m)[1]) for k, m in
          (("client_table", ct), ("key_table", kt), ("client_hash_table", ht))}
    j_stream, j_flags = jdk.decode_updates_v1(
        jnp.asarray(buf), jnp.asarray(lens), **dims, **jt,
        primary_root_hash=None if prim is None else jnp.asarray(np.asarray(prim, np.int32)))
    t_stream, t_flags = tdk.decode_updates_v1(
        torch.from_numpy(buf), torch.from_numpy(lens), **dims, **tt,
        primary_root_hash=None if prim is None else torch.tensor(prim, dtype=torch.int32))
    return j_stream, np.asarray(j_flags), t_stream, t_flags.numpy()


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_decode_with_tables_matches_ytpu(case):
    j_stream, j_flags, t_stream, t_flags = _decode_pair(TABLE_PAYLOADS, _case_tables(case))
    for name in j_stream._fields:
        np.testing.assert_array_equal(np.asarray(getattr(j_stream, name)), getattr(t_stream, name).numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(j_flags, t_flags)
    seen = int(np.bitwise_or.reduce(t_flags & tdk.FLAG_ERRORS))
    want = TABLE_CASES[case]
    if want:
        assert seen & want
    if case == "all":
        assert seen == tdk.FLAG_UNSUPPORTED
        ok = (t_flags & tdk.FLAG_ERRORS) == 0
        valid = t_stream.valid.numpy() & ok[:, None]
        assert (t_stream.key.numpy()[valid] >= 0).any()  # map rows got their key ids
        assert (t_stream.p_root.numpy()[valid] >= 0).any()  # non-primary roots their anchors
        assert (t_stream.client.numpy()[valid] >= 0).all()  # every client interned, big ones too


# --- no tables: unchanged ---------------------------------------------------------------

# sha256 over the int32 bytes of every UpdateBatch field, then the flags, of
# `decode_updates_v1` without tables, recorded from the decode before the
# intern tables were added
NO_TABLE_DIGESTS = {
    "b4_512": "783629286086a83295a28e3567558eba633511e8d7b158bf760c6945e9bbba8d",
    "config5": "c037d7417b645b35f0f084eaaaf75308d70b328e1f503a7133aeb9ce4c74bb4b",
    "decode_corpus": "68b6268676f14cfac61c3b9a5138a5be11d0fb59a368eed1681f473654075968",
}


def _no_table_inputs(name):
    import pickle

    if name == "b4_512":
        with gzip.open(os.path.join(ROOT, "benches", "data", "b4_log.pkl.gz"), "rb") as f:
            return pickle.load(f)["log"][:512], dict(max_rows=4, max_dels=4)
    if name == "config5":
        from ytpu_torch.benches.sync_step import config5_updates

        return config5_updates(64), dict(max_rows=1, max_dels=1)
    from test_torch_decode import corpus

    return corpus(), dict(max_rows=16, max_dels=8, n_steps=400, max_sections=8)


@pytest.mark.parametrize("name", sorted(NO_TABLE_DIGESTS))
def test_decode_without_tables_is_unchanged(name):
    payloads, dims = _no_table_inputs(name)
    buf, lens = tdk.pack_updates(payloads)
    stream, flags = tdk.decode_updates_v1(torch.from_numpy(buf), torch.from_numpy(lens), **dims)
    h = hashlib.sha256()
    for f in list(stream) + [flags]:
        h.update(f.numpy().astype(np.int32).tobytes())
    assert h.hexdigest() == NO_TABLE_DIGESTS[name]
    j_stream, j_flags = jdk.decode_updates_v1(jnp.asarray(buf), jnp.asarray(lens), **dims)
    for f in stream._fields:
        np.testing.assert_array_equal(np.asarray(getattr(j_stream, f)), getattr(stream, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(j_flags), flags.numpy())


def test_chunked_wire_payloads_match_ytpu():
    """`ChunkedWirePayloads` over two retained chunks: text, Any, Json,
    Embed, Format and Type spans resolve as ytpu's does, and dropping the
    latest chunk works only for the latest."""
    from ytpu.models.batch_doc import PayloadStore as JaxStore
    from ytpu_torch.models.batch_doc import PayloadStore

    j = jdk.ChunkedWirePayloads(JaxStore())
    t = tdk.ChunkedWirePayloads(PayloadStore())
    a = np.frombuffer(b"\x05hello\x02\x7d\x01\x77\x02hi", dtype=np.uint8)
    b = np.frombuffer(b"\x01\x0b" + b'"{\\"k\\":1}"' + b"\x01b\x04true" + b"\x03\x03div", dtype=np.uint8)
    for x in (a, b):
        assert j.add_chunk(x) == t.add_chunk(x)
    assert t.slice_text(-2 - 1, 1, 3) == j.slice_text(-2 - 1, 1, 3) == "ell"
    assert t.slice_values(-2 - 6, 0, 2) == j.slice_values(-2 - 6, 0, 2)
    base = a.size
    assert t.json_values(-2 - base, 0, 1) == j.json_values(-2 - base, 0, 1)
    assert t.format_kv(-2 - base - 13) == j.format_kv(-2 - base - 13)
    assert t.type_branch(-2 - base - 20).type_name == j.type_branch(-2 - base - 20).type_name == "div"
    assert t.type_raw(-2 - base - 20) == j.type_raw(-2 - base - 20)
    t.drop_if_unreferenced(0)
    assert t.total_bytes == a.size + b.size
    t.drop_if_unreferenced(base)
    assert t.total_bytes == a.size
