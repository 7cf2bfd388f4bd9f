"""The V2 lane sets shared by the V2 decode tests and `chip_smoke.py`'s
``decode_v2`` phase: wire updates built with the JAX package's host doc
(the port has no host CRDT), transcoded to V2, plus hand-made carriers
(legacy Json, sub-document) and damaged copies.

`build_sets()` returns name -> {"payloads": [V2 bytes], "U", "R", "SEC"};
every set decodes at U = 8, R = 4 and 4 sections (one compile of the JAX
decode covers them all). `tables()` gives the key and big-client hash
tables for every key and 53-bit client the sets use.

``python tests/_torch_v2_cases.py`` rewrites
``ytpu_torch/benches/data/v2_cases.json`` (hex payloads and the tables),
which `chip_smoke.py` reads; `tests/test_torch_decode_v2.py` checks that
the file is what `build_sets()` builds.
"""

import json
import os
import random
import string
import sys
from collections import deque
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DATA = ROOT / "ytpu_torch" / "benches" / "data" / "v2_cases.json"
U, R, SEC = 8, 4, 4
BIG_A = (1 << 52) + 12345
BIG_B = (1 << 45) + 7
BIG_C = (1 << 31) + 5  # just past i32
MAP_KEYS = ("title", "x", "k", "list", "obj", "id", "deep", "b", "cfg", "n0", "n1", "n2")


def _capture(doc):
    log = []
    doc.observe_update_v1(lambda p, o, t: log.append(p))
    return log


def _v2(p: bytes) -> bytes:
    from ytpu.core import Update

    return Update.decode_v1(p).encode_v2()


def _text_log(seed: int, client: int, n: int):
    from ytpu.core import Doc

    rng = random.Random(seed)
    doc = Doc(client_id=client)
    log = _capture(doc)
    t = doc.get_text("text")
    for _ in range(n):
        with doc.transact() as txn:
            k = len(t)
            if k > 6 and rng.random() < 0.35:
                t.remove_range(txn, rng.randint(0, k - 3), rng.randint(1, 3))
            else:
                word = "".join(rng.choice(string.ascii_lowercase + "éπ🙂") for _ in range(rng.randint(1, 6)))
                t.insert(txn, rng.randint(0, k), word)
    return doc, log


def _text():
    _, log = _text_log(11, 1, 40)
    return log


def _deletes():
    from ytpu.core import Doc

    doc, log = _text_log(12, 3, 24)
    t = doc.get_text("text")
    with doc.transact() as txn:  # several ranges in one delete set
        for i in range(4):
            if len(t) > 2 * i + 2:
                t.remove_range(txn, 2 * i, 1)
    other = Doc(client_id=4)
    other.apply_update_v1(doc.encode_state_as_update_v1())
    with other.transact() as txn:
        other.get_text("text").remove_range(txn, 0, 2)
    return log + [other.encode_state_as_update_v1()]


def _multi_client_skips():
    from ytpu.compat import merge_updates
    from ytpu.core import Doc
    from ytpu.core.state_vector import StateVector

    d1 = Doc(client_id=1)
    with d1.transact() as txn:
        d1.get_text("text").insert(txn, 0, "aaaa")
    d2 = Doc(client_id=2)
    d2.apply_update_v1(d1.encode_state_as_update_v1(StateVector({})))
    with d2.transact() as txn:
        d2.get_text("text").insert(txn, 2, "bb")
    u_all = d2.encode_state_as_update_v1(StateVector({}))
    l1 = _capture(d1)
    with d1.transact() as txn:
        d1.get_text("text").insert(txn, 0, "x")
    with d1.transact() as txn:
        d1.get_text("text").insert(txn, 0, "y")
    with d1.transact() as txn:
        d1.get_text("text").insert(txn, 1, "z")
    full = d1.encode_state_as_update_v1(StateVector({}))
    # gapped merges: the merge writes Skip blocks over the holes
    return [merge_updates(u_all, full), merge_updates(u_all, l1[1]), merge_updates(l1[0], l1[2]),
            merge_updates(u_all, l1[2]), u_all]


def _map_keys():
    from ytpu.core import Doc
    from ytpu.types.shared import ArrayPrelim, MapPrelim

    doc = Doc(client_id=7)
    log = _capture(doc)
    m = doc.get_map("config")
    with doc.transact() as txn:
        m.insert(txn, "title", "zedoc")
    with doc.transact() as txn:
        m.insert(txn, "x", 42)
    with doc.transact() as txn:
        m.insert(txn, "x", 43)  # LWW replacement
    with doc.transact() as txn:
        m.insert(txn, "list", ArrayPrelim([1, "two", None, 3.5]))
    with doc.transact() as txn:
        m.insert(txn, "obj", MapPrelim({"k": True}))
    with doc.transact() as txn:
        m.remove(txn, "title")
    return log + [doc.encode_state_as_update_v1()]


def _big_clients():
    from ytpu.core import Doc
    from ytpu.core.state_vector import StateVector

    d1 = Doc(client_id=BIG_A)
    with d1.transact() as txn:
        d1.get_text("t").insert(txn, 0, "from-a")
    d2 = Doc(client_id=BIG_B)
    d2.apply_update_v1(d1.encode_state_as_update_v1(StateVector({})))
    l2 = _capture(d2)
    with d2.transact() as txn:
        d2.get_text("t").insert(txn, 3, "-b-")
    with d2.transact() as txn:
        d2.get_text("t").remove_range(txn, 0, 1)  # the delete set's client is big too
    d3 = Doc(client_id=BIG_C)
    d3.apply_update_v1(d2.encode_state_as_update_v1(StateVector({})))
    l3 = _capture(d3)
    with d3.transact() as txn:
        d3.get_text("t").insert(txn, 1, "c")
    arr = Doc(client_id=BIG_A)
    la = _capture(arr)
    with arr.transact() as txn:
        arr.get_array("a").insert_range(txn, 0, [1, 2, 3])
    with arr.transact() as txn:
        arr.get_array("a").move_to(txn, 0, 2)  # Move ids of a big client
    return [d2.encode_state_as_update_v1(StateVector({}))] + l2 + l3 + la + [
        d3.encode_state_as_update_v1(StateVector({}))]


def _content_kinds():
    """Any, Binary, Move, Embed, Format, Type, a legacy Json carrier and a
    sub-document (unsupported on the device lane)."""
    from ytpu.core import Doc
    from ytpu.types import XmlElementPrelim
    from ytpu.types.shared import TextPrelim

    from ytpu_torch.core.block import Item
    from ytpu_torch.core.content import ContentDoc, ContentJSON
    from ytpu_torch.core.doc import Doc as TDoc
    from ytpu_torch.core.doc import Options
    from ytpu_torch.core.id_set import DeleteSet
    from ytpu_torch.core.ids import ID
    from ytpu_torch.core.update import Update as TUpdate

    d = Doc(client_id=3)
    log = _capture(d)
    arr = d.get_array("a")
    with d.transact() as txn:
        arr.insert_range(txn, 0, [1, "two", 3.5, True, None, -7, 1 << 40])
    with d.transact() as txn:
        arr.insert_range(txn, 2, [[1, 2], {"k": 7}])
    with d.transact() as txn:
        arr.insert_range(txn, 0, [b"\x00\xffbinary"])
    with d.transact() as txn:
        arr.remove_range(txn, 2, 2)
    with d.transact() as txn:
        arr.move_to(txn, 1, 3)
    with d.transact() as txn:
        arr.move_range_to(txn, 2, 4, 0)
    with d.transact() as txn:
        arr.insert(txn, 0, TextPrelim("nested text"))
    out = list(log)
    t = Doc(client_id=11)
    tl = _capture(t)
    tt = t.get_text("t")
    with t.transact() as txn:
        tt.insert(txn, 0, "hello world")
    with t.transact() as txn:
        tt.format(txn, 0, 5, {"bold": True})
    with t.transact() as txn:
        tt.insert_embed(txn, 5, {"img": "x.png"})
    frag = t.get_xml_fragment("x")
    with t.transact() as txn:
        frag.insert(txn, 0, XmlElementPrelim("div", attributes={"id": "a1"}))
    out += tl + [t.encode_state_as_update_v1()]
    v2 = [_v2(p) for p in out]
    json_item = Item(ID(99, 0), None, None, None, None, "j", None, ContentJSON(["1", '{"a": 2}']))
    v2.append(TUpdate({99: deque([json_item])}, DeleteSet()).encode_v2())
    sub = TDoc(options=Options(client_id=0, guid="guid-1", should_load=False))
    doc_item = Item(ID(98, 0), None, None, None, None, "d", None, ContentDoc(sub))
    v2.append(TUpdate({98: deque([doc_item])}, DeleteSet()).encode_v2())
    return v2


def _nested_any():
    from ytpu.core import Doc

    d = Doc(client_id=5)
    log = _capture(d)
    arr = d.get_array("a")
    with d.transact() as txn:
        arr.insert_range(txn, 0, [{"deep": [1, 2, 3]}, {"a": {"b": 7}, "c": [4, [5, 6]]},
                                  [{"x": [1, {"y": 2}]}, 9], {"e": [], "f": 2}, [{"g": [1, []]}, {}, []], "plain"])
    with d.transact() as txn:
        arr.insert(txn, 2, {"tail": {"k": [10]}})
    with d.transact() as txn:
        arr.insert(txn, 0, {"a": {"b": {"c": 1}}})  # three map levels: the deepest that decodes
    with d.transact() as txn:
        arr.insert(txn, 0, {"a": {"b": {"c": {"d": 1}}}})  # four: unsupported
    with d.transact() as txn:
        arr.insert(txn, 0, [[[[[{"a": 1}]]]]])  # arrays nest freely
    return log


def _frame(cols, rest):
    """A V2 update from its nine column buffers and its rest stream."""
    from ytpu.encoding.lib0 import Writer

    w = Writer()
    w.write_u8(0)
    for c in cols:
        w.write_buf(c)
    w.write_raw(rest)
    return w.to_bytes()


def _split(p):
    from ytpu.encoding.lib0 import Cursor

    cur = Cursor(p)
    cur.read_u8()
    cols = [cur.read_buf() for _ in range(9)]
    return cols, p[cur.pos:]


def _truncated_columns(base):
    """Each column in turn cut short (its last byte dropped), and the
    string blob's UTF-16 length column cut."""
    out = []
    for p in base:
        cols, rest = _split(p)
        for k in range(9):
            if cols[k]:
                cut = list(cols)
                cut[k] = cols[k][:-1]
                out.append(_frame(cut, rest))
    return out


def _zero_spans(rng):
    """Payloads whose frame split fails: the pack gives all-zero spans."""
    out = [b"\x00", b"\x00\x05ab", b"\x00\xff", bytes([0, 3, 1, 2])]
    out += [bytes([0]) + rng.integers(0x80, 256, int(n), dtype=np.uint8).tobytes() for n in (1, 3, 9)]
    out += [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in rng.integers(2, 40, 12)]
    return out


def _rest_past_span(base):
    """The rest stream cut mid-varint or ending on a continuation byte:
    varints that run past the span."""
    out = []
    for p in base:
        cols, rest = _split(p)
        if len(rest) > 1:
            out.append(_frame(cols, rest[:-1]))
            out.append(_frame(cols, rest[:-1] + b"\x80"))
        out.append(_frame(cols, rest + b"\x81\x82"))
        out.append(_frame(cols, b"\xff" * 3))
    return out


def _uvar(x: int) -> bytes:
    out = bytearray()
    while True:
        b, x = x & 0x7F, x >> 7
        out.append(b | (0x80 if x else 0))
        if not x:
            return bytes(out)


def _sections_out_of_order(lanes):
    """A lane of three client sections whose second block count is a
    5-byte varint that wraps to -3 or -2: the third section starts before
    the second, so a block's section can start after the block (its clock
    subtracts the length prefix there). The lanes decode without an error
    flag."""
    from ytpu.encoding.lib0 import Cursor

    out = []
    for p in lanes:
        cols, rest = _split(p)
        cur, slots = Cursor(rest), []
        while cur.pos < len(rest) and len(slots) < 6:
            start = cur.pos
            slots.append((start, cur.read_var_uint(), cur.pos))
        if len(slots) < 6 or slots[0][1] != 3:
            continue
        (s1, _, e1), (s2, _, e2) = slots[3], slots[5]
        for nb1, nb2 in ((-3, 1), (-3, 3), (-2, 2)):
            out.append(_frame(cols, rest[:s1] + _uvar(nb1 & 0xFFFFFFFF) + rest[e1:s2] + _uvar(nb2) + rest[e2:]))
    return out


def _wrapped_string_length(base):
    """A string column with a 5-byte length varint past 32 bits that wraps
    to -3 after its first entry: the strings' cumulative unit targets
    fall, so the search for a later string's first byte starts over."""
    from ytpu.encoding.lib0 import Cursor

    wrapped = bytes([0x80 | ((2**32 - 3) & 0x3F)]) + _uvar((2**32 - 3) >> 6)  # magnitude 2^32 - 3, no run
    out = []
    for p in base:
        cols, rest = _split(p)
        if not cols[5]:
            continue
        sc = cols[5]
        cur = Cursor(sc)
        at = cur.read_var_uint() + cur.pos  # the lengths column, after the blob
        if at >= len(sc):
            continue
        run = sc[at] & 0x40  # a negative entry: a run count follows
        while sc[at] & 0x80:
            at += 1
        at += 1
        if run:
            cur.pos = at
            cur.read_var_uint()
            at = cur.pos
        out.append(_frame(cols[:5] + [sc[:at] + wrapped + sc[at:]] + cols[6:], rest))
    return out


def _overflow():
    """More rows than U, more delete ranges than R, more client sections
    than SEC (and than R + 4 delete sections), and a lane whose Any values
    outlast the rest walker's step budget."""
    from ytpu.compat import merge_updates
    from ytpu.core import Doc

    doc, log = _text_log(13, 21, 30)
    out = [doc.encode_state_as_update_v1()]  # whole state: many rows and ranges
    t = doc.get_text("text")
    with doc.transact() as txn:
        for i in range(7):
            if len(t) > 2 * i + 1:
                t.remove_range(txn, i, 1)
    out.append(doc.encode_state_as_update_v1())
    docs = []
    for c in range(30, 37):  # seven clients: seven sections
        d = Doc(client_id=c)
        with d.transact() as txn:
            d.get_text("text").insert(txn, 0, chr(ord("a") + c - 30))
        docs.append(d.encode_state_as_update_v1())
    out.append(merge_updates(*docs))
    ds = []
    for c in range(40, 50):  # ten clients with deletes: ten delete sections
        d = Doc(client_id=c)
        with d.transact() as txn:
            d.get_text("text").insert(txn, 0, "ab")
        with d.transact() as txn:
            d.get_text("text").remove_range(txn, 0, 1)
        ds.append(d.encode_state_as_update_v1())
    out.append(merge_updates(*ds))
    d = Doc(client_id=51)
    with d.transact() as txn:  # one block of 250 Any values: past the walker's step budget
        d.get_array("a").insert_range(txn, 0, list(range(250)))
    out.append(d.encode_state_as_update_v1())
    return out


def _mutated(payloads, rng, n: int):
    """`n` seeded copies with one to three bytes overwritten and, one in
    four, cut short."""
    out = []
    for i in range(n):
        p = bytearray(payloads[i % len(payloads)])
        for _ in range(int(rng.integers(1, 4))):
            p[int(rng.integers(0, len(p)))] = int(rng.integers(0, 256))
        if rng.integers(0, 4) == 0:
            p = p[: int(rng.integers(1, len(p) + 1))]
        out.append(bytes(p))
    return out


def build_sets() -> dict:
    rng = np.random.default_rng(20261018)
    sets = {
        "text": [_v2(p) for p in _text()],
        "deletes": [_v2(p) for p in _deletes()],
        "multi_client_skips": [_v2(p) for p in _multi_client_skips()],
        "map_keys": [_v2(p) for p in _map_keys()],
        "big_clients": [_v2(p) for p in _big_clients()],
        "content_kinds": _content_kinds(),
        "nested_any": [_v2(p) for p in _nested_any()],
        "overflow": [_v2(p) for p in _overflow()],
    }
    base = [p for name in ("text", "map_keys", "big_clients", "content_kinds") for p in sets[name][:6]]
    sets["truncated_columns"] = _truncated_columns(base)
    sets["zero_spans"] = _zero_spans(rng)
    sets["rest_past_span"] = _rest_past_span(base)
    every = [p for v in list(sets.values()) for p in v]
    sets["mutated"] = _mutated(every, rng, 384)
    sets["sections_out_of_order"] = _sections_out_of_order(sets["big_clients"])
    sets["wrapped_string_length"] = _wrapped_string_length(sets["text"][:6] + sets["map_keys"][:6])
    return {name: {"payloads": v, "U": U, "R": R, "SEC": SEC} for name, v in sets.items()}


def tables() -> dict:
    """The key table (parent_sub keys and root names by `key_hash_host`)
    and the big-client hash table (`client_hash_host`), as sorted
    ``(keys, perm)`` int lists."""
    from ytpu_torch.ops.decode_kernel import client_hash_host, key_hash_host

    kh = {key_hash_host(k.encode()): i for i, k in enumerate(MAP_KEYS)}
    ch = {client_hash_host(c): i for i, c in enumerate((BIG_A, BIG_B, BIG_C))}
    return {"key_table": [sorted(kh), [kh[h] for h in sorted(kh)]],
            "client_hash_table": [sorted(ch), [ch[h] for h in sorted(ch)]]}


def to_json(sets: dict) -> dict:
    return {"sets": {k: {**{w: v[w] for w in ("U", "R", "SEC")}, "payloads": [p.hex() for p in v["payloads"]]}
                     for k, v in sets.items()}, "tables": tables()}


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    DATA.write_text(json.dumps(to_json(build_sets()), indent=0, sort_keys=True) + "\n")
    print(DATA)
