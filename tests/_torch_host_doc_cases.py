"""Seeded scenarios for the host CRDT, written once against a package's
`Doc` and shared types so that the same operations run on ytpu's host CRDT
and on the port's (``tests/test_torch_host_doc.py``).

A scenario takes a `Pkg` (the package's `Doc`, `Options` and ``types``
module), a numpy generator and whether the docs garbage-collect, and
returns a `Record`: everything the docs produced that the two packages
must agree on, in plain Python values (bytes, numbers, strings, lists,
dicts), so two records compare with ``==``.
"""

from __future__ import annotations

import gzip
import os
import pickle
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pkg(name: str) -> SimpleNamespace:
    """`Doc`, `Options`, `StateVector` and the ``types`` module of package
    `name` (``ytpu`` or ``ytpu_torch``)."""
    import importlib

    doc = importlib.import_module(f"{name}.core.doc")
    sv = importlib.import_module(f"{name}.core.state_vector")
    return SimpleNamespace(Doc=doc.Doc, Options=doc.Options, StateVector=sv.StateVector,
                           types=importlib.import_module(f"{name}.types"), name=name)


def norm(v):
    """A package-independent form of a value a shared type returns."""
    if isinstance(v, dict):
        return {k: norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    if hasattr(v, "guid") and hasattr(v, "options"):  # a sub-document
        return ("doc", v.guid)
    if hasattr(v, "branch") and hasattr(v, "to_json"):  # a shared type
        return (type(v).__name__, norm(v.to_json()))
    if type(v).__name__ == "Diff":
        return ("diff", norm(v.insert), norm(v.attributes))
    if type(v).__name__ == "BigInt":
        return ("bigint", int(v))
    return v


def _event(e) -> dict:
    out = {"path": norm(e.path()), "target": type(e.target).__name__ if not hasattr(e.target, "type_ref")
           else e.target.type_ref}
    try:
        out["delta"] = [(c.kind, norm(c.values), c.len, norm(c.attributes)) for c in e.delta()]
    except IndexError:
        # ytpu's `Event.delta` indexes a text item's values by UTF-16
        # offset, so an astral character in an inserted run raises there;
        # the port is held to the same outcome
        out["delta"] = "IndexError"
    out["keys"] = {k: (c.action, norm(c.old_value), norm(c.new_value)) for k, c in sorted(e.keys().items())}
    return out


TYPE_WEAK = 7  # a weak link's type ref (the same in both packages)


def _is_link(event: dict) -> bool:
    return event["target"] == TYPE_WEAK


def _events(evs) -> list:
    """A deep observer's batch of events, in the order the package fired
    them, except that each run of consecutive weak-link events of one depth
    is sorted: such a run comes from one walk over a set of branches (the
    weak links that quote a changed item, `store.linked_by`), which
    iterates by object address."""
    out = [_event(e) for e in evs]
    i = 0
    while i < len(out):
        j = i + 1
        if _is_link(out[i]):
            while j < len(out) and _is_link(out[j]) and len(out[j]["path"]) == len(out[i]["path"]):
                j += 1
            out[i:j] = sorted(out[i:j], key=repr)
        i = j
    return out


@dataclass
class Record:
    updates_v1: List[bytes] = field(default_factory=list)
    updates_v2: List[bytes] = field(default_factory=list)
    events: List[list] = field(default_factory=list)
    subdocs: List[tuple] = field(default_factory=list)
    finals: Dict[str, dict] = field(default_factory=dict)


def watch(doc, rec: Record, roots=()) -> None:
    """Record `doc`'s v1 and v2 transaction updates, its sub-document events
    and the deep events of `roots` (shared types of `doc`)."""
    doc.observe_update_v1(lambda p, origin, txn: rec.updates_v1.append(bytes(p)))
    doc.observe_update_v2(lambda p, origin, txn: rec.updates_v2.append(bytes(p)))
    doc.observe_subdocs(lambda txn, a, r, l: rec.subdocs.append((sorted(a), sorted(r), sorted(l))))
    for root in roots:
        root.observe_deep(lambda txn, evs: rec.events.append(_events(evs)))


def finish(P, rec: Record, name: str, doc, mid_sv=None, snapshot=None) -> None:
    """What `doc` holds at the end: its v1 and v2 state updates, state vector
    bytes, the diff against `mid_sv`, its values, and with gc off the state
    at `snapshot`."""
    out = {
        "v1": doc.encode_state_as_update_v1(),
        "v2": doc.encode_state_as_update_v2(),
        "sv": doc.state_vector().encode_v1(),
        "json": norm(doc.to_json()),
    }
    if mid_sv is not None:
        out["diff_v1"] = doc.encode_state_as_update_v1(P.StateVector(dict(mid_sv)))
        out["diff_v2"] = doc.encode_state_as_update_v2(P.StateVector(dict(mid_sv)))
    if snapshot is not None:
        out["snapshot"] = snapshot.encode_v1()
        out["at_snapshot"] = doc.encode_state_from_snapshot(snapshot)
    rec.finals[name] = out


def _doc(P, client_id: int, gc: bool, **kw):
    return P.Doc(options=P.Options(client_id=client_id, guid=f"doc-{client_id}", skip_gc=not gc, **kw))


def _rand_text(rng, n: int) -> str:
    alphabet = "abcdé πx🙂\n"
    return "".join(alphabet[int(i)] for i in rng.integers(0, len(alphabet), n))


def _run_author(P, rng, gc: bool, steps: int, roots: Callable, op: Callable) -> Record:
    """One author doc (client 7): `roots(doc)` returns the shared types to
    watch, `op(doc, roots, txn, rng, k)` makes step k's edits. The middle
    state vector and snapshot are taken after step ``steps // 2``. A
    replica (client 8) applies every update, and both are finished."""
    rec = Record()
    doc = _doc(P, 7, gc)
    rs = roots(doc)
    watch(doc, rec, rs)
    mid_sv = snap = None
    for k in range(steps):
        with doc.transact() as txn:
            op(doc, rs, txn, rng, k)
        if k == steps // 2:
            mid_sv = dict(doc.state_vector().clocks)
            snap = None if gc else doc.snapshot()
    replica = _doc(P, 8, gc)
    for u in rec.updates_v1:
        replica.apply_update_v1(u)
    finish(P, rec, "author", doc, mid_sv, snap)
    finish(P, rec, "replica", replica, mid_sv)
    return rec


def text_scenario(P, rng, gc: bool) -> Record:
    """Text insert, delete and format, with embeds."""

    def op(doc, rs, txn, rng, k):
        t = rs[0]
        n = len(t.get_string())
        a = int(rng.integers(0, 4))
        if a == 0 or n < 4:
            t.insert(txn, int(rng.integers(0, n + 1)), _rand_text(rng, int(rng.integers(1, 6))))
        elif a == 1:
            i = int(rng.integers(0, n - 1))
            t.remove_range(txn, i, int(rng.integers(1, min(4, n - i) + 1)))
        elif a == 2:
            i = int(rng.integers(0, n - 1))
            attrs = [{"bold": True}, {"italic": True}, {"bold": None}, {"color": "#f00"}][int(rng.integers(0, 4))]
            t.format(txn, i, int(rng.integers(1, min(5, n - i) + 1)), attrs)
        else:
            t.insert_embed(txn, int(rng.integers(0, n + 1)), {"img": f"i{k}.png"})

    return _run_author(P, rng, gc, 48, lambda d: [d.get_text("t")], op)


def array_scenario(P, rng, gc: bool) -> Record:
    """Array insert, delete and move."""

    def op(doc, rs, txn, rng, k):
        a = rs[0]
        n = len(a.to_list())
        c = int(rng.integers(0, 5))
        if c <= 1 or n < 4:
            vals = [int(x) for x in rng.integers(0, 1000, int(rng.integers(1, 4)))]
            if c == 1:
                vals = [f"s{v}" for v in vals] + [None, True, 2.5, b"\x01\x02", [1, {"x": 2}]]
            a.insert_range(txn, int(rng.integers(0, n + 1)), vals)
        elif c == 2:
            i = int(rng.integers(0, n - 1))
            a.remove_range(txn, i, int(rng.integers(1, min(3, n - i) + 1)))
        elif c == 3:
            a.move_to(txn, int(rng.integers(0, n)), int(rng.integers(0, n + 1)))
        else:
            s = int(rng.integers(0, n - 2))
            e = int(rng.integers(s, min(s + 3, n - 1)))
            tgt = int(rng.integers(0, n + 1))
            if s <= tgt <= e + 1:
                tgt = 0 if s > 0 else n
            a.move_range_to(txn, s, e, tgt)

    return _run_author(P, rng, gc, 48, lambda d: [d.get_array("a")], op)


def map_scenario(P, rng, gc: bool) -> Record:
    """Map set and delete, and nested types."""
    T = P.types

    def op(doc, rs, txn, rng, k):
        m = rs[0]
        keys = sorted(m.keys())
        c = int(rng.integers(0, 6))
        key = f"k{int(rng.integers(0, 8))}"
        if c <= 1 or not keys:
            m.insert(txn, key, [int(rng.integers(0, 100)), "v", {"n": k}][int(rng.integers(0, 3))])
        elif c == 2:
            m.remove(txn, keys[int(rng.integers(0, len(keys)))])
        elif c == 3:
            m.insert(txn, key, T.MapPrelim({"inner": k, "deep": [1, 2]}))
        elif c == 4:
            m.insert(txn, key, T.TextPrelim(f"nested {k}"))
        else:
            m.insert(txn, key, T.ArrayPrelim([k, k + 1]))
            got = m.get(key)
            got.insert(txn, 1, T.MapPrelim({"z": k}))

    return _run_author(P, rng, gc, 40, lambda d: [d.get_map("m")], op)


def xml_scenario(P, rng, gc: bool) -> Record:
    """XML elements, attributes and text."""
    T = P.types

    def op(doc, rs, txn, rng, k):
        frag = rs[0]
        kids = list(frag.children())
        c = int(rng.integers(0, 5))
        if c == 0 or not kids:
            frag.insert(txn, int(rng.integers(0, len(kids) + 1)),
                        T.XmlElementPrelim(["div", "p", "span"][int(rng.integers(0, 3))],
                                           attributes={"id": f"e{k}"}))
        elif c == 1:
            frag.insert(txn, int(rng.integers(0, len(kids) + 1)), T.XmlTextPrelim(_rand_text(rng, 4)))
        elif c == 2:
            el = kids[int(rng.integers(0, len(kids)))]
            if hasattr(el, "insert_attribute"):
                el.insert_attribute(txn, f"a{int(rng.integers(0, 3))}", f"v{k}")
            else:
                el.insert(txn, 0, _rand_text(rng, 3))
        elif c == 3:
            el = kids[int(rng.integers(0, len(kids)))]
            if hasattr(el, "tag"):
                el.insert(txn, 0, T.XmlTextPrelim(f"t{k}"))
            elif hasattr(el, "remove_range") and len(el.get_string()) > 1:
                el.remove_range(txn, 0, 1)
        else:
            frag.remove_range(txn, int(rng.integers(0, len(kids))), 1)

    return _run_author(P, rng, gc, 40, lambda d: [d.get_xml_fragment("x")], op)


def weak_scenario(P, rng, gc: bool) -> Record:
    """Weak quotes of an array and a text, and map links, with edits inside
    and around the quoted ranges."""
    T = P.types

    def op(doc, rs, txn, rng, k):
        arr, m, data, text = rs
        if k == 0:
            arr.insert_range(txn, 0, list(range(12)))
            text.insert(txn, 0, "quoted text here")
            for i in range(4):
                data.insert(txn, f"d{i}", i)
            return
        c = int(rng.integers(0, 5))
        n = len(arr.to_list())
        if c == 0 and n >= 3:
            i = int(rng.integers(0, n - 2))
            m.insert(txn, f"q{k}", T.quote_range(arr, txn, i, int(rng.integers(1, min(4, n - i) + 1))))
        elif c == 1:
            link = T.map_link(data, f"d{int(rng.integers(0, 4))}")
            if link is not None:
                m.insert(txn, f"l{k}", link)
        elif c == 2:
            data.insert(txn, f"d{int(rng.integers(0, 4))}", f"new{k}")
        elif c == 3 and n > 1:
            if rng.integers(0, 2):
                arr.remove_range(txn, int(rng.integers(0, n)), 1)
            else:
                arr.insert(txn, int(rng.integers(0, n + 1)), 100 + k)
        else:
            tl = len(text.get_string())
            i = int(rng.integers(0, tl - 2))
            m.insert(txn, f"t{k}", T.quote_range(text, txn, i, 2))

    def roots(d):
        return [d.get_array("a"), d.get_map("m"), d.get_map("data"), d.get_text("t")]

    rec = _run_author(P, rng, gc, 32, roots, op)
    return rec


def subdoc_scenario(P, rng, gc: bool) -> Record:
    """Sub-documents inserted, loaded, synced to a replica and removed."""
    rec = Record()
    parent = _doc(P, 7, gc)
    arr = parent.get_array("docs")
    m = parent.get_map("named")
    watch(parent, rec, [arr, m])
    mid_sv = snap = None
    for k in range(12):
        c = int(rng.integers(0, 3))
        with parent.transact() as txn:
            if c == 0 or not arr.to_list():
                child = P.Doc(options=P.Options(client_id=7, guid=f"child-{k}", auto_load=bool(k % 2),
                                                collection_id="col" if k % 3 == 0 else None))
                arr.insert(txn, int(rng.integers(0, len(arr.to_list()) + 1)), child)
            elif c == 1:
                m.insert(txn, f"s{k}", P.Doc(options=P.Options(client_id=7, guid=f"named-{k}")))
            else:
                arr.remove(txn, int(rng.integers(0, len(arr.to_list()))))
        if k == 6:
            mid_sv = dict(parent.state_vector().clocks)
            snap = None if gc else parent.snapshot()
    replica = _doc(P, 8, gc)
    replica_rec = Record()
    watch(replica, replica_rec)
    replica.apply_update_v1(parent.encode_state_as_update_v1())
    rec.subdocs.append(("replica", replica_rec.subdocs))
    rec.subdocs.append(("replica_subdocs", sorted(
        (g, d.options.should_load, d.options.auto_load, d.options.collection_id)
        for g, d in replica.store.subdocs.items())))
    finish(P, rec, "parent", parent, mid_sv, snap)
    finish(P, rec, "replica", replica, mid_sv)
    return rec


def peers_scenario(P, rng, gc: bool) -> Record:
    """Three peers make seeded random concurrent edits on a text, an array
    and a map; each then receives the others' updates in a seeded order, so
    that out-of-order updates wait in the pending stash."""
    rec = Record()
    peers = [_doc(P, c, gc) for c in (1, 2, 3)]
    logs: List[List[bytes]] = [[] for _ in peers]
    for i, d in enumerate(peers):
        d.observe_update_v1(lambda p, o, t, _i=i: logs[_i].append(bytes(p)) if o != "sync" else None)
    for i, d in enumerate(peers):
        d.get_text("t").observe_deep(lambda txn, evs, _i=i: rec.events.append([_i] + _events(evs)))
    for rnd in range(3):
        for i, d in enumerate(peers):
            t, a, m = d.get_text("t"), d.get_array("a"), d.get_map("m")
            for _ in range(6):
                with d.transact() as txn:
                    c = int(rng.integers(0, 5))
                    n = len(t.get_string())
                    if c <= 1 or n < 3:
                        t.insert(txn, int(rng.integers(0, n + 1)), _rand_text(rng, int(rng.integers(1, 4))))
                    elif c == 2:
                        t.remove_range(txn, int(rng.integers(0, n - 1)), 1)
                    elif c == 3:
                        a.insert(txn, int(rng.integers(0, len(a.to_list()) + 1)), int(rng.integers(0, 99)))
                    else:
                        m.insert(txn, f"k{int(rng.integers(0, 4))}", f"p{i}r{rnd}")
        # exchange this round's updates, each peer in its own seeded order
        for i, d in enumerate(peers):
            incoming = [u for j, lg in enumerate(logs) if j != i for u in lg]
            stashes = []
            for j in rng.permutation(len(incoming)):
                d.apply_update_v1(incoming[int(j)], origin="sync")
                if d.store.pending is not None:
                    stashes.append((int(j), d.store.pending.update.encode_v1(),
                                    d.store.pending.missing.encode_v1()))
            rec.finals[f"peer{i}-round{rnd}"] = {"stashes": stashes}
    for i, d in enumerate(peers):
        finish(P, rec, f"peer{i}", d, {1: 3, 2: 5})
    return rec


def replay_scenario(P, log: List[bytes], gc: bool) -> Record:
    """A doc (client 9) that applies `log` in order; its transactions'
    re-encoded updates, its deep events and its final state are recorded."""
    rec = Record()
    doc = _doc(P, 9, gc)
    doc.observe_update_v1(lambda p, origin, txn: rec.updates_v1.append(bytes(p)))
    doc.observe_update_v2(lambda p, origin, txn: rec.updates_v2.append(bytes(p)))
    mid_sv = snap = None
    watched = set()
    for k, u in enumerate(log):
        doc.apply_update_v1(u)
        # watch each root from the first update that integrates into it
        for name, branch in sorted(doc.store.types.items()):
            if name not in watched:
                watched.add(name)
                P.types.wrap_branch(branch).observe_deep(lambda txn, evs: rec.events.append(_events(evs)))
        if k == len(log) // 2:
            mid_sv = dict(doc.state_vector().clocks)
            snap = None if gc else doc.snapshot()
    finish(P, rec, "doc", doc, mid_sv, snap)
    return rec


def b4_log(n: int = 2048) -> List[bytes]:
    with gzip.open(os.path.join(ROOT, "benches", "data", "b4_log.pkl.gz"), "rb") as f:
        return pickle.load(f)["log"][:n]


def ingest_logs() -> Dict[str, dict]:
    from ytpu_torch.benches import ingest as ingest_bench

    return ingest_bench.load_ingest_logs()


AUTHORED = {
    "text": text_scenario,
    "array": array_scenario,
    "map": map_scenario,
    "xml": xml_scenario,
    "weak": weak_scenario,
    "subdocs": subdoc_scenario,
    "peers": peers_scenario,
}


def run(scenario: str, package: str, gc: bool, seed: int = 20) -> Record:
    """Scenario `scenario` on package `package`: an authored one from
    `AUTHORED` (seeded by `seed`), ``b4_in_order`` / ``b4_swapped`` (the
    first 2,048 B4 updates, the second with each pair swapped), or
    ``log_<name>`` (a log of ``ingest_logs.json``)."""
    P = pkg(package)
    if scenario in AUTHORED:
        return AUTHORED[scenario](P, np.random.default_rng(seed), gc)
    if scenario.startswith("b4_"):
        log = b4_log()
        if scenario == "b4_swapped":
            log = [log[i ^ 1] for i in range(len(log))]
        return replay_scenario(P, log, gc)
    if scenario.startswith("log_"):
        return replay_scenario(P, ingest_logs()[scenario[4:]]["log"], gc)
    raise KeyError(scenario)


SCENARIOS = list(AUTHORED) + ["b4_in_order", "b4_swapped", "log_map_xml", "log_array", "log_big_client_text"]
