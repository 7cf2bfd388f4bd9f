"""Shared inputs of the batch-ingest tests (tests/test_torch_ingest.py,
tests/test_torch_update_decode.py): v1 update logs written by ytpu's host
`Doc` (text, 53-bit client ids, maps, nested types, XML, moves, WeakRef
quotes, multi-root docs, several clients, degenerate wire shapes) and the
ingest scenarios both packages' `BatchIngestor` run, step by step."""

import random

from ytpu.core import Doc
from ytpu.encoding.lib0 import Writer
from ytpu.types.shared import ArrayPrelim, MapPrelim, TextPrelim, XmlElementPrelim

BIG = (1 << 40) + 7  # a client id beyond i32, as real Yjs clients are


def capture(doc):
    log = []
    doc.observe_update_v1(lambda p, o, t: log.append(p))
    return log


def edits(client_id, steps):
    """One payload per transaction; each step is ``fn(doc, txn)``."""
    doc = Doc(client_id=client_id)
    log = capture(doc)
    for fn in steps:
        with doc.transact() as txn:
            fn(doc, txn)
    return doc, log


def text_log(ops, client_id=1, root="text"):
    """Inserts ("i", pos, str) and deletes ("d", pos, n) on one text."""

    def step(op):
        tag, pos, arg = op
        if tag == "i":
            return lambda d, t: d.get_text(root).insert(t, pos, arg)
        return lambda d, t: d.get_text(root).remove_range(t, pos, arg)

    doc, log = edits(client_id, [step(op) for op in ops])
    return log, doc.get_text(root).get_string()


def random_text_log(seed, n, client_id=1):
    rng = random.Random(seed)
    ops, length = [], 0
    for _ in range(n):
        if length > 8 and rng.random() < 0.3:
            pos = rng.randint(0, length - 2)
            k = rng.randint(1, 2)
            ops.append(("d", pos, k))
            length -= k
        else:
            w = "".join(rng.choice("abcd éπ🙂") for _ in range(rng.randint(1, 5)))
            ops.append(("i", rng.randint(0, length), w))
            length += len(w)
    return text_log(ops, client_id)


def map_log():
    """Scalars, an overwrite, an array value and a depth-1 object (device
    tokens), a remove, an object holding an array (host lane)."""

    def two(d, t):
        d.get_map("m").insert(t, "name", "bob")  # overwrite tombstones the loser
        d.get_map("m").insert(t, "flags", [True, None, 2.5])

    def three(d, t):
        d.get_map("m").insert(t, "flat", {"x": 1, "y": "v"})
        d.get_map("m").insert(t, "score", 2.5)

    steps = [
        lambda d, t: d.get_map("m").insert(t, "name", "alice"),
        lambda d, t: d.get_map("m").insert(t, "age", 31),
        two,
        lambda d, t: d.get_map("m").remove(t, "age"),
        three,
        lambda d, t: d.get_map("m").insert(t, "obj", {"k": [1]}),
    ]
    doc, log = edits(7, steps)
    return log, doc.get_map("m").to_json()


def nested_log():
    """A map holding a nested text, map and array, edited through their
    branch-id parents."""

    def first(d, t):
        d.get_map("root").insert(t, "title", "plain value")
        d.get_map("root").insert(t, "body", TextPrelim("nested"))

    steps = [
        first,
        lambda d, t: d.get_map("root").get("body").insert(t, 6, " text"),
        lambda d, t: d.get_map("root").insert(t, "sub", MapPrelim({"a": True})),
        lambda d, t: d.get_map("root").get("sub").insert(t, "inner", 5),
        lambda d, t: d.get_map("root").insert(t, "list", ArrayPrelim([1, "two"])),
        lambda d, t: d.get_map("root").get("list").insert(t, 1, "mid"),
    ]
    doc, log = edits(1, steps)
    return log, doc.get_map("root").to_json()


def multi_root_log():
    """Three named roots: text "body" (the primary), text "title", map
    "meta"; the last transaction writes two roots."""
    def both(d, t):
        d.get_text("title").insert(t, 7, "?")
        d.get_text("body").insert(t, 0, "* ")

    steps = [
        lambda d, t: d.get_text("body").insert(t, 0, "content here"),
        lambda d, t: d.get_text("title").insert(t, 0, "A Title"),
        lambda d, t: d.get_map("meta").insert(t, "lang", "en"),
        both,
    ]
    doc, log = edits(3, steps)
    return log, doc


def xml_log(n_steps=40, seed=13):
    """ytpu's config #4 tenant shape (benches/device.py
    stream_workload_map_xml) at a small size: map "m" writes and removes,
    XML elements with an attribute appended to fragment "x"."""
    rng = random.Random(seed)
    doc = Doc(client_id=1)
    log = capture(doc)
    m = doc.get_map("m")
    frag = doc.get_xml_fragment("x")
    for s in range(n_steps):
        with doc.transact() as txn:
            r = rng.random()
            if r < 0.5:
                m.insert(txn, f"k{rng.randrange(8)}", rng.randrange(1000))
            elif r < 0.7 and len(m) > 0:
                m.remove(txn, next(iter(m.keys())))
            else:
                frag.insert(txn, len(frag), XmlElementPrelim(f"div{s % 7}", attributes={"i": str(s)}))
    return log, doc


def move_log():
    """An array with moved elements and a moved range."""
    def fill(d, t):
        for i in range(6):
            d.get_array("a").push_back(t, i)

    steps = [
        fill,
        lambda d, t: d.get_array("a").move_to(t, 1, 4),
        lambda d, t: d.get_array("a").move_range_to(t, 2, 3, 0),
        lambda d, t: d.get_array("a").insert(t, 2, "x"),
        lambda d, t: d.get_array("a").remove_range(t, 0, 1),
    ]
    doc, log = edits(5, steps)
    return log, doc.get_array("a").to_json()


def weak_log():
    """A text and an array holding a WeakRef quote of it (host lane)."""
    from ytpu.types.weak import quote_range

    d = Doc(client_id=7)
    log = capture(d)
    src = d.get_text("src")
    with d.transact() as txn:
        src.insert(txn, 0, "quote me")
    with d.transact() as txn:
        d.get_array("links").insert(txn, 0, quote_range(src, txn, 1, 4))
    return log


def rich_text_log():
    """Formatting marks, an embed, plain inserts."""
    doc = Doc(client_id=3)
    log = capture(doc)
    t = doc.get_text("text")
    with doc.transact() as txn:
        t.insert(txn, 0, "plain ")
    with doc.transact() as txn:
        t.insert_with_attributes(txn, 6, "bold", {"b": True})
    with doc.transact() as txn:
        t.insert_embed(txn, 10, {"img": "x.png"})
    with doc.transact() as txn:
        t.insert(txn, 11, " tail")
    return log, doc.get_text("text").get_string()


def two_client_update():
    """A merged two-client update whose wire order is causally valid."""
    d1, d2 = Doc(client_id=1), Doc(client_id=2)
    with d1.transact() as txn:
        d1.get_text("text").insert(txn, 0, "aa")
    d2.apply_update_v1(d1.encode_state_as_update_v1())
    with d2.transact() as txn:
        d2.get_text("text").insert(txn, 2, "bb")
    return d2.encode_state_as_update_v1(), d2.get_text("text").get_string()


def catchup_pair():
    """Client 20 quotes client 10's content: (A's update, B's update)."""
    a = Doc(client_id=10)
    with a.transact() as txn:
        a.get_text("text").insert(txn, 0, "base")
    ua = a.encode_state_as_update_v1()
    b = Doc(client_id=20)
    b.apply_update_v1(ua)
    log = capture(b)
    with b.transact() as txn:
        b.get_text("text").insert(txn, 4, "-tail")
    return ua, log[0]


def array_clients_log(n_clients=6, ops_per_client=3, seed=11):
    """ytpu's config #3 shape (benches/device.py stream_workload_array) at a
    small size: peers edit one array through a relay doc."""
    rng = random.Random(seed)
    relay = Doc(client_id=0xFFFF)
    log = capture(relay)
    peers = [Doc(client_id=i + 1) for i in range(n_clients)]
    order = [i for i in range(n_clients) for _ in range(ops_per_client)]
    rng.shuffle(order)
    for i in order:
        peer = peers[i]
        arr = peer.get_array("a")
        n = len(arr)
        with peer.transact() as txn:
            if n > 4 and rng.random() < 0.3:
                arr.remove_range(txn, rng.randrange(n), 1)
            else:
                arr.insert(txn, rng.randrange(n + 1), [rng.randrange(1000)])
        relay.apply_update_v1(peer.encode_state_as_update_v1(relay.state_vector()))
        if rng.random() < 0.5:
            peer.apply_update_v1(relay.encode_state_as_update_v1(peer.state_vector()))
    return log, relay.get_array("a").to_json()


def degenerate_updates():
    """Wire-legal degenerate updates: no blocks and 40 empty delete-set
    sections; 30 client sections each holding one Skip run."""
    w = Writer()
    w.write_var_uint(0)
    w.write_var_uint(40)
    for c in range(40):
        w.write_var_uint(c + 1)
        w.write_var_uint(0)
    empty_ds = w.to_bytes()
    w = Writer()
    w.write_var_uint(30)
    for c in range(30):
        w.write_var_uint(1)
        w.write_var_uint(c + 100)
        w.write_var_uint(0)
        w.write_u8(10)  # Skip
        w.write_var_uint(5)
    w.write_var_uint(0)
    return empty_ds, w.to_bytes()


def wire_corpus():
    """Every payload of the logs above plus a truncated one, for the
    column walk and the host decode."""
    out = []
    out += text_log([("i", 0, "hello wörld π🙂"), ("i", 3, "XY"), ("d", 1, 4)])[0]
    out += text_log([("i", 0, "big"), ("i", 3, " ids"), ("d", 0, 1)], client_id=BIG)[0]
    out += map_log()[0]
    out += nested_log()[0]
    out += multi_root_log()[0]
    out += xml_log(12)[0]
    out += move_log()[0]
    out += weak_log()
    out += rich_text_log()[0]
    out += array_clients_log(3, 2)[0]
    out.append(two_client_update()[0])
    out += list(catchup_pair())
    out += list(degenerate_updates())
    out.append(out[0][:-3])  # truncated
    out.append(b"\x00\x00")
    return out


# --- ingest scenarios -----------------------------------------------------------
# Each scenario: (n_docs, steps), a step being the payloads of its docs
# (None = no update). The host-lane scenarios run through `apply`, the
# fast-lane ones through `apply_bytes`; each group runs as the doc slots of
# one ingestor (`combined`), so ytpu compiles one program per step and
# shape, not one per scenario.
CAPACITY = 256


def host_lane_scenarios():
    out = {}
    _, pend = edits(7, [lambda d, t: d.get_text("text").insert(t, 0, "first"),
                        lambda d, t: d.get_text("text").insert(t, 5, "-second")])
    out["pending_out_of_order"] = (2, [[pend[1], pend[0]], [pend[0], pend[1]]])
    _, pa = edits(1, [lambda d, t: d.get_text("text").insert(t, 0, "a0"),
                      lambda d, t: d.get_text("text").insert(t, 2, "a1")])
    _, pb = edits(2, [lambda d, t: d.get_text("text").insert(t, 0, "b0")])
    out["pending_does_not_stall"] = (2, [[pa[1], pb[0]]])
    _, pd = edits(3, [lambda d, t: d.get_text("text").insert(t, 0, "abcdef"),
                      lambda d, t: d.get_text("text").remove_range(t, 1, 3)])
    out["pending_delete_set"] = (1, [[pd[1]], [pd[0]]])
    ua, ub = catchup_pair()
    out["interleaved_catchup"] = (1, [[ub], [ua]])
    _, pm = edits(5, [lambda d, t: d.get_map("text").insert(t, "k", 1),
                      lambda d, t: d.get_map("text").insert(t, "k", 2)])
    out["pending_map_overwrite"] = (1, [[pm[1]], [pm[0]]])
    _, rd = edits(9, [lambda d, t: d.get_text("text").insert(t, 0, "base"),
                      lambda d, t: d.get_text("text").insert(t, 4, "-dep")])
    out["redelivery"] = (1, [[rd[1]]] * 4 + [[rd[0]], [rd[1]]])
    log, _ = random_text_log(11, 6)
    out["host_lane_text"] = (1, [[p] for p in log])
    log, _ = multi_root_log()
    out["host_lane_multi_root"] = (1, [[p] for p in log])
    return out


def fast_lane_scenarios():
    out = {}
    log, _ = text_log([("i", 0, "hello"), ("i", 5, " world"), ("d", 2, 3), ("i", 4, "🙂π")])
    out["fast_in_order"] = (2, [[p, p] for p in log])
    log, _ = text_log([("i", 0, "abc"), ("i", 3, "def"), ("i", 6, "ghi")])
    out["fast_gap_stashes"] = (2, [[log[0], log[0]], [log[2], log[1]], [log[1], log[2]]])
    log0, _ = text_log([("i", 0, "fast lane")])
    out["mixed_lanes_weak"] = (2, [[log0[0], p] for p in weak_log()])
    out["map_rows"] = (1, [[p] for p in map_log()[0]])
    log, _ = text_log([("i", 0, "big"), ("i", 3, " ids"), ("d", 0, 1)], client_id=BIG)
    out["big_client"] = (1, [[p] for p in log])
    out["multi_client"] = (1, [[two_client_update()[0]]])
    out["multi_root"] = (2, [[p, p] for p in multi_root_log()[0]])
    out["nested_types"] = (1, [[p] for p in nested_log()[0]])
    out["map_and_xml"] = (1, [[p] for p in xml_log(6)[0]])
    out["moves"] = (1, [[p] for p in move_log()[0]])
    out["format_embed"] = (1, [[p] for p in rich_text_log()[0]])
    log, _ = text_log([("i", 0, "abcdef"), ("d", 1, 3), ("d", 0, 2)])
    out["delete_only"] = (1, [[p] for p in log])
    empty_ds, skip_heavy = degenerate_updates()
    tail, _ = text_log([("i", 0, "still alive")])
    out["degenerate_wire"] = (1, [[empty_ds], [skip_heavy], [tail[0]]])
    out["array_clients"] = (1, [[p] for p in array_clients_log(3, 2)[0]])
    log, _ = random_text_log(11, 6)
    out["fast_lane_text"] = (1, [[p] for p in log])
    log, _ = multi_root_log()
    out["fast_lane_multi_root"] = (1, [[p] for p in log])
    return out


def combined(scenarios):
    """The scenarios as the doc slots of one ingestor: ``(n_docs, steps,
    {name: slice of its docs})``, step t holding each scenario's step t
    (None once its log is done)."""
    slices, first = {}, 0
    for name, (n, _) in scenarios.items():
        slices[name] = slice(first, first + n)
        first += n
    n_steps = max(len(steps) for _, steps in scenarios.values())
    steps = []
    for t in range(n_steps):
        row = [None] * first
        for name, (n, sc) in scenarios.items():
            if t < len(sc):
                row[slices[name]] = sc[t]
        steps.append(row)
    return first, steps, slices
