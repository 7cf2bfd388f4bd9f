"""The port's device decode (`ytpu_torch.ops.decode_kernel`) and wire walker
(`ytpu_torch.encoding.lib0`) against the JAX package on the CPU.

`gather_raw_lanes` + `decode_updates_v1` must reproduce every UpdateBatch
column and every lane's flags of the JAX state machine exactly, on a B4
chunk and on a mixed corpus (map, nested, move, Any values, unicode, GC,
and malformed or unsupported lanes whose flags must match too).
"""

import gzip
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ytpu.core import Doc
from ytpu.models import replay as jreplay
from ytpu.native import available as native_available
from ytpu.native import decode_update_columns
from ytpu.ops import decode_kernel as jdk

from ytpu_torch.encoding.lib0 import update_columns
from ytpu_torch.models import replay as treplay
from ytpu_torch.ops import decode_kernel as tdk

# one intra-op thread: these cases are op-bound, and the suite runs
# several test processes side by side
torch.set_num_threads(1)

needs_native = pytest.mark.skipif(not native_available(), reason="native codec unavailable")

B4_LOG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "benches", "data", "b4_log.pkl.gz")


def b4_log(n):
    with gzip.open(B4_LOG, "rb") as f:
        return pickle.load(f)["log"][:n]


def capture(doc):
    log = []
    doc.observe_update_v1(lambda p, o, t: log.append(p))
    return log


def corpus():
    """Wire updates covering every decode path the replay can meet."""
    from ytpu.types.shared import ArrayPrelim, MapPrelim, TextPrelim, XmlElementPrelim

    out = []
    doc = Doc(client_id=1)
    log = capture(doc)
    t = doc.get_text("text")
    with doc.transact() as txn:
        t.insert(txn, 0, "hello wörld π🙂")
    with doc.transact() as txn:
        t.insert(txn, 3, "XY")
    with doc.transact() as txn:
        t.remove_range(txn, 1, 4)
    out += log

    doc = Doc(client_id=2)
    log = capture(doc)
    m = doc.get_map("m")
    with doc.transact() as txn:
        m.insert(txn, "k", "v")  # map row without key table: FLAG_UNKNOWN_KEY
    with doc.transact() as txn:
        m.insert(txn, "list", ArrayPrelim([1, "two", None, 3.5]))
    with doc.transact() as txn:
        m.insert(txn, "obj", MapPrelim({"a": True}))
    out += log

    doc = Doc(client_id=3)
    log = capture(doc)
    arr = doc.get_array("root")
    with doc.transact() as txn:
        arr.insert(txn, 0, TextPrelim("nested text"))
    with doc.transact() as txn:
        for i in range(5):
            arr.push_back(txn, i)
    with doc.transact() as txn:
        arr.move_to(txn, 1, 4)
    with doc.transact() as txn:
        arr.move_range_to(txn, 2, 3, 0)
    with doc.transact() as txn:
        arr.insert(txn, 0, {"name": "zed", "age": 7})
    with doc.transact() as txn:
        arr.insert(txn, 1, [1, {"k": None}, "s"])
    with doc.transact() as txn:
        arr.insert(txn, 0, [[1, 2], {"deep": {"x": 1}}])  # recursive Any: unsupported
    frag = doc.get_xml_fragment("xml")
    with doc.transact() as txn:
        frag.insert(txn, 0, XmlElementPrelim("div"))
    out += log

    merged = Doc(client_id=4)
    other = Doc(client_id=5)
    ml = capture(merged)
    with other.transact() as txn:
        other.get_text("text").insert(txn, 0, "ab")
    merged.apply_update_v1(other.encode_state_as_update_v1())
    with merged.transact() as txn:
        merged.get_text("text").insert(txn, 1, "c")
    out += [merged.encode_state_as_update_v1()] + ml  # multi-client update

    big = Doc(client_id=(1 << 40) + 7)
    bl = capture(big)
    with big.transact() as txn:
        big.get_text("text").insert(txn, 0, "big")  # FLAG_BIG_CLIENT
    out += bl
    out.append(out[0][:-3])  # truncated: FLAG_MALFORMED
    out.append(b"\x00\x00")
    return out


def decode_both(payloads, U=4, R=4, n_steps=96, max_sections=None):
    buf, lens = jdk.pack_updates(payloads)
    tbuf, tlens = tdk.pack_updates(payloads)
    np.testing.assert_array_equal(buf, tbuf)
    np.testing.assert_array_equal(lens, tlens)
    j_stream, j_flags = jdk.decode_updates_v1(
        jnp.asarray(buf), jnp.asarray(lens), U, R, n_steps=n_steps, max_sections=max_sections
    )
    t_stream, t_flags = tdk.decode_updates_v1(
        torch.from_numpy(buf), torch.from_numpy(lens), U, R, n_steps=n_steps,
        max_sections=max_sections,
    )
    return j_stream, np.asarray(j_flags), t_stream, t_flags.numpy()


def assert_stream_equal(j_stream, t_stream):
    for name in j_stream._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(j_stream, name)), getattr(t_stream, name).numpy(), err_msg=name
        )


@needs_native
def test_b4_chunk_gather_and_decode_match():
    log = b4_log(1024)
    plan = jreplay.plan_replay(log)
    wire, woffs = jreplay.build_wire_table(log)
    cap = jreplay.raw_chunk_cap(woffs, len(log))
    assert cap == treplay.raw_chunk_cap(woffs, len(log))
    raw = np.zeros(cap, np.uint8)
    offs = np.zeros(len(log), np.int32)
    lens = np.zeros(len(log), np.int32)
    n = jdk.pack_raw_updates_into(wire, woffs, 0, len(log), raw, offs, lens, width=plan.max_len + 16)
    raw2, offs2, lens2 = np.zeros_like(raw), np.zeros_like(offs), np.zeros_like(lens)
    assert n == tdk.pack_raw_updates_into(wire, woffs, 0, len(log), raw2, offs2, lens2,
                                          width=plan.max_len + 16)
    for a, b in ((raw, raw2), (offs, offs2), (lens, lens2)):
        np.testing.assert_array_equal(a, b)
    width = plan.max_len + 16
    j_buf = jdk.gather_raw_lanes(jnp.asarray(raw), jnp.asarray(offs), jnp.asarray(lens), width)
    t_buf = tdk.gather_raw_lanes(torch.from_numpy(raw), torch.from_numpy(offs), torch.from_numpy(lens), width)
    np.testing.assert_array_equal(np.asarray(j_buf), t_buf.numpy())
    dims = dict(max_rows=plan.max_rows, max_dels=plan.max_dels, n_steps=plan.max_steps,
                max_sections=plan.max_sections)
    j_stream, j_flags = jdk.decode_updates_v1(j_buf, jnp.asarray(lens), **dims)
    t_stream, t_flags = tdk.decode_updates_v1(t_buf, torch.from_numpy(lens), **dims)
    assert_stream_equal(j_stream, t_stream)
    np.testing.assert_array_equal(np.asarray(j_flags), t_flags.numpy())
    assert int(t_stream.valid.sum()) > 900 and int(t_stream.del_valid.sum()) > 0
    assert not (t_flags.numpy() & tdk.FLAG_ERRORS).any()


def test_corpus_decode_and_flags_match():
    payloads = corpus()
    j_stream, j_flags, t_stream, t_flags = decode_both(payloads)
    assert_stream_equal(j_stream, t_stream)
    np.testing.assert_array_equal(j_flags, t_flags)
    seen = int(np.bitwise_or.reduce(t_flags))
    for flag in (tdk.FLAG_UNKNOWN_KEY, tdk.FLAG_UNSUPPORTED, tdk.FLAG_BIG_CLIENT,
                 tdk.FLAG_MALFORMED, tdk.FLAG_MULTI_CLIENT):
        assert seen & flag, flag
    kinds = set(t_stream.kind[t_stream.valid].tolist())
    assert {4, 7, 8, 11} <= kinds  # string, type, any, move rows decoded clean


def test_overflow_and_step_budget_flags_match():
    """Too few row/delete slots (FLAG_OVERFLOW), a step budget that runs
    out (FLAG_MALFORMED) and a header guard below the section count."""
    payloads = corpus()[:8]
    for U, R, T, sec in ((1, 1, 12, None), (4, 4, 96, 0)):
        j_stream, j_flags, t_stream, t_flags = decode_both(payloads, U, R, T, sec)
        assert_stream_equal(j_stream, t_stream)
        np.testing.assert_array_equal(j_flags, t_flags)


@needs_native
def test_update_columns_match_native_walker():
    """The pure-Python walker yields what plan_replay reads from the
    native column decoder, on B4 updates and the corpus."""
    for p in b4_log(400) + corpus()[:-2]:
        nat = decode_update_columns(p)
        py = update_columns(p)
        assert py.error == nat.error
        for name in ("n_blocks", "n_dels", "n_client_sections", "n_ds_sections",
                     "n_zero_len_blocks", "n_value_steps"):
            assert getattr(py, name) == getattr(nat, name), name
        for name in ("kind", "client", "clock", "length"):
            np.testing.assert_array_equal(getattr(py, name), getattr(nat, name), err_msg=name)
        for i in range(nat.n_blocks):
            if int(nat.kind[i]) not in (0, 10):
                assert py.content_bytes(i) == nat.content_bytes(i)
        assert tdk.steps_for_columns(py) == jdk.steps_for_columns(nat)


def test_host_helpers_match():
    payloads = corpus()
    buf = np.zeros((len(payloads) + 2, 96), np.uint8)
    lens = np.zeros(len(payloads) + 2, np.int32)
    buf2, lens2 = buf.copy(), lens.copy()
    jdk.pack_updates_into(payloads, buf, lens)
    tdk.pack_updates_into(payloads, buf2, lens2)
    np.testing.assert_array_equal(buf, buf2)
    np.testing.assert_array_equal(lens, lens2)
    for key in (b"", b"k", b"a much longer parent_sub key beyond the window"):
        assert tdk.key_hash_host(key) == jdk.key_hash_host(key)
    for client in (0, 1, 127, 128, (1 << 40) + 7, (1 << 53) - 1):
        assert tdk.client_hash_host(client) == jdk.client_hash_host(client)
    assert tdk.default_steps(3, 5) == jdk.default_steps(3, 5)
    assert tdk.exact_steps(1, 2, 3, 4, 5, 6) == jdk.exact_steps(1, 2, 3, 4, 5, 6)
    np.testing.assert_array_equal(tdk.identity_rank(16, "cpu").numpy(), np.asarray(jdk.identity_rank(16)))
    assert tdk.EMPTY_UPDATE == jdk.EMPTY_UPDATE
    assert tdk.FLAG_ERRORS == jdk.FLAG_ERRORS
