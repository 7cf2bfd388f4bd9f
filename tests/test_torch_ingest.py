"""The port's `BatchIngestor` (`ytpu_torch.models.ingest`) against ytpu's
on the CPU: the same payloads, step by step, through both packages' host
lane (`apply`) and fast lane (`apply_bytes`), then equal state-vector
mirrors, pending stashes, packed columns, sticky errors and rendered
values (`get_string`, `get_values`, `get_map`, `get_tree`).

The fast lane's content refs point into each package's own retained wire
chunks; they are compared byte for byte only where both ingestors sent
the same number of docs down the fast lane (ytpu's lane choice depends on
whether its native column decoder loaded), and through the payload
readers always. Each scenario runs once per package per module.

Also here: the committed ``ytpu_torch/benches/data/ingest_logs.json``
(the inputs of ``chip_smoke.py``'s ``ingest`` phase) against a fresh
generation by ytpu's host `Doc`; ``python tests/test_torch_ingest.py``
rewrites it.
"""

import contextlib
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from ytpu.core import Doc  # noqa: E402
from ytpu.models import batch_doc as jbd  # noqa: E402
from ytpu.models.ingest import BatchIngestor as JaxIngestor  # noqa: E402

import _torch_ingest_cases as cases  # noqa: E402
from ytpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from ytpu_torch.models import batch_doc as tbd  # noqa: E402
from ytpu_torch.models import ingest as tingest  # noqa: E402
from ytpu_torch.models.ingest import BatchIngestor as TorchIngestor  # noqa: E402

torch.set_num_threads(1)
# (method, scenarios): each group runs as the doc slots of one ingestor
# ("apply_v2": the host-lane scenarios as V2 bytes through `apply(v2=True)`)
GROUPS = {"apply": cases.host_lane_scenarios(), "apply_bytes": cases.fast_lane_scenarios(),
          "apply_v2": cases.host_lane_scenarios()}
NAMES = [(method, name) for method, sc in GROUPS.items() for name in sc]


def _pending_view(ing, doc):
    """The stash of one doc as plain values: carriers by client (id, len,
    kind of carrier) and the pending delete set's squashed ranges."""
    u = ing.pending_update(doc)
    blocks = {} if u is None else {
        c: [(b.id.clock, b.len, type(b).__name__) for b in q] for c, q in u.blocks.items()}
    ds = ing.pending_ds(doc)
    ranges = {} if ds is None else {c: ds.ranges(c) for c in ds.clients if ds.ranges(c)}
    return blocks, ranges


def _summary(ing, state):
    bd = jbd if isinstance(ing, JaxIngestor) else tbd
    docs = range(ing.n_docs)
    return {
        "svs": [dict(sv.clocks) for sv in ing.svs],
        "pending": [_pending_view(ing, d) for d in docs],
        "planes": state_to_numpy(state),
        "lanes": (ing.fast_docs, ing.slow_docs, ing.fast_recoveries),
        "trees": [bd.get_tree(state, d, ing.payloads, ing.enc.keys, interner=ing.enc.interner) for d in docs],
        "values": [bd.get_values(state, d, ing.payloads) for d in docs],
        "strings": [bd.get_string(state, d, ing.payloads) for d in docs],
        "primary_roots": dict(ing.primary_roots),
        "keys": dict(ing.enc.keys.ids),
        "clients": list(ing.enc.interner.from_idx),
    }


def run(pkg, method, steps, n_docs, start=None, patch=None):
    """Drive one package's ingestor through `steps` (lists of payloads) by
    `method`; `start` is a numpy state snapshot (`state_to_numpy`) to begin
    from, `patch` a context manager factory wrapping the run."""
    if pkg == "jax":
        ing = JaxIngestor(n_docs, cases.CAPACITY)
        if start is not None:
            ing.state = jbd.DocStateBatch(
                jbd.BlockCols(**{n: jnp.asarray(start[n]) for n in jbd.BlockCols._fields}),
                *(jnp.asarray(start[n]) for n in ("start", "n_blocks", "error")))
    else:
        ing = TorchIngestor(n_docs, cases.CAPACITY, device="cpu")
        if start is not None:
            ing.state = state_from_numpy(start, "cpu")
    with (patch() if patch else contextlib.nullcontext()):
        for payloads in steps:
            if method == "apply_v2":
                ing.apply(payloads, v2=True)
            else:
                getattr(ing, method)(payloads)
    state = ing.state if pkg == "jax" else tbd.ensure_origin_slot(ing.state)
    return ing, _summary(ing, state)


@contextlib.contextmanager
def _sabotage():
    """Both packages' decode call number SABOTAGED_CALL comes back flagged
    FLAG_MALFORMED with no valid rows: the ingestors must rewind their
    mirrors and replay the flagged docs through the host lane."""
    from ytpu.ops import decode_kernel as jdk

    j_real, t_real = jdk.decode_updates_v1, tingest.decode_updates_v1

    def wrap(real, np_like):
        calls = [0]

        def sabotage(buf, lens, max_rows, max_dels, **kw):
            stream, flags = real(buf, lens, max_rows, max_dels, **kw)
            calls[0] += 1
            if calls[0] == SABOTAGED_CALL + 1:
                flags = flags | jdk.FLAG_MALFORMED
                stream = stream._replace(valid=np_like.zeros_like(stream.valid),
                                         del_valid=np_like.zeros_like(stream.del_valid))
            return stream, flags
        return sabotage

    jdk.decode_updates_v1 = wrap(j_real, jnp)
    tingest.decode_updates_v1 = wrap(t_real, torch)
    try:
        yield
    finally:
        jdk.decode_updates_v1 = j_real
        tingest.decode_updates_v1 = t_real


# the fast-lane group's decode call that comes back flagged in both
# packages (`_sabotage`): its docs must be replayed through the host lane
SABOTAGED_CALL = 2
_GROUP_RUNS = {}


def group_run(method):
    """Both packages' summaries of one group, the docs of each scenario and
    the port's ingestor; computed once per process."""
    if method not in _GROUP_RUNS:
        n_docs, steps, slices = cases.combined(GROUPS[method])
        if method == "apply_v2":
            from ytpu_torch.core.update import Update

            steps = [[None if p is None else Update.decode_v1(p).encode_v2() for p in step] for step in steps]
        patch = _sabotage if method == "apply_bytes" else None
        j = run("jax", method, steps, n_docs, patch=patch)[1]
        t_ing, t = run("torch", method, steps, n_docs, patch=patch)
        _GROUP_RUNS[method] = (j, t, slices, t_ing)
    return _GROUP_RUNS[method]


class _Runs:
    def __getitem__(self, method):
        return group_run(method)


@pytest.fixture
def runs():
    return _Runs()


def _docs(runs, method, name):
    j, t, slices, _ = runs[method]
    return j, t, slices[name]


@pytest.mark.parametrize("method,name", NAMES)
def test_mirrors_and_stashes_match(runs, method, name):
    j, t, docs = _docs(runs, method, name)
    assert t["svs"][docs] == j["svs"][docs]
    assert t["pending"][docs] == j["pending"][docs]
    ids = range(docs.start, docs.stop)
    assert {d: t["primary_roots"].get(d) for d in ids} == {d: j["primary_roots"].get(d) for d in ids}


CLIENT_PLANES = ("client", "origin_client", "ror_client", "mv_sc", "mv_ec")


def _real(summary, plane, docs):
    """A client plane as real client ids, the key plane as key names (-1
    and None where unset): what stays equal when the two packages interned
    in another order."""
    a = summary["planes"][plane][docs]
    if plane == "key":
        names = {i: k for k, i in summary["keys"].items()}
        return [[names.get(int(v)) for v in row] for row in a]
    ids = np.asarray(summary["clients"] + [-1], dtype=np.int64)
    return ids[a]


@pytest.mark.parametrize("method,name", NAMES)
def test_packed_columns_match(runs, method, name):
    """Every plane, n_blocks, start and error of the scenario's docs. Where
    the two packages sent other docs down the fast lane (ytpu's native
    column decoder did not load), content refs differ by construction and
    interned ids are compared as the real ids and key names they stand
    for."""
    j, t, docs = _docs(runs, method, name)
    same_lanes = j["lanes"][0] == t["lanes"][0]
    for plane, want in j["planes"].items():
        if same_lanes:
            np.testing.assert_array_equal(t["planes"][plane][docs], want[docs], err_msg=plane)
        elif plane in CLIENT_PLANES or plane == "key":
            np.testing.assert_array_equal(_real(t, plane, docs), _real(j, plane, docs), err_msg=plane)
        elif plane != "content_ref":
            np.testing.assert_array_equal(t["planes"][plane][docs], want[docs], err_msg=plane)
    assert int(t["planes"]["error"][docs].max()) == 0


@pytest.mark.parametrize("method,name", NAMES)
def test_rendered_values_match(runs, method, name):
    j, t, docs = _docs(runs, method, name)
    assert t["trees"][docs] == j["trees"][docs]
    assert t["values"][docs] == j["values"][docs]
    assert t["strings"][docs] == j["strings"][docs]


def test_v2_apply_equals_v1_apply(runs):
    """The port's `apply(v2=True)` on the V2 form of the host-lane
    scenarios ends in the state, mirrors, stashes and values of `apply` on
    their V1 form."""
    _, v1, _, _ = runs["apply"]
    _, v2, _, _ = runs["apply_v2"]
    for key in ("svs", "pending", "trees", "values", "strings", "primary_roots", "keys", "clients"):
        assert v2[key] == v1[key], key
    for plane, want in v1["planes"].items():
        np.testing.assert_array_equal(v2["planes"][plane], want, err_msg=plane)


def test_interners_match(runs):
    """Equal intern tables; in the same order where both packages took the
    same lanes."""
    for method in GROUPS:
        j, t, _, _ = runs[method]
        if j["lanes"][0] == t["lanes"][0]:
            assert t["keys"] == j["keys"]
            assert t["clients"] == j["clients"]
        assert set(t["keys"]) == set(j["keys"])
        assert set(t["clients"]) == set(j["clients"])


def test_port_lanes(runs):
    """The port always has its column walk: in-order device-decodable
    updates (53-bit ids, map rows, multi-root docs, nested types, moves)
    ride its fast lane; stashes, WeakRef quotes, recursive Any values and a
    wire order that puts a client before its origin take the host lane."""
    _, t, slices, ing = runs["apply_bytes"]
    sc = GROUPS["apply_bytes"]
    n_updates = sum(p is not None for _, steps in sc.values() for row in steps for p in row)
    host = {"map_rows": 1, "mixed_lanes_weak": 1, "multi_client": 1, "fast_gap_stashes": 3}
    assert ing.slow_docs == sum(host.values())
    assert ing.fast_docs == n_updates - ing.slow_docs


def test_flag_recovery_replays_through_host_lane(runs):
    """The sabotaged step's fast docs were replayed through the host lane
    in both packages; the group's comparisons above hold after it."""
    j, t, _, ing = runs["apply_bytes"]
    assert 0 < ing.fast_recoveries < ing.n_docs
    if j["lanes"][0] == t["lanes"][0]:
        assert j["lanes"][2] == t["lanes"][2]


def test_both_lanes_render_the_same_doc(runs):
    """The same logs through the port's host lane and its fast lane end in
    the same columns (content refs and intern order apart) and the same
    values."""
    _, h, hs, h_ing = runs["apply"]
    _, f, fs, f_ing = runs["apply_bytes"]

    def real_ids(planes, ing, docs):
        ids = np.asarray(ing.enc.interner.from_idx + [-1], dtype=np.int64)
        return ids[planes["client"][docs]]

    for kind in ("text", "multi_root"):
        a, b = hs[f"host_lane_{kind}"], fs[f"fast_lane_{kind}"]
        assert h["trees"][a] == f["trees"][b] and h["svs"][a] == f["svs"][b]
        np.testing.assert_array_equal(real_ids(h["planes"], h_ing, a), real_ids(f["planes"], f_ing, b))
        for plane in ("clock", "length", "left", "right", "deleted", "parent", "kind", "n_blocks"):
            np.testing.assert_array_equal(h["planes"][plane][a], f["planes"][plane][b], err_msg=plane)


def test_text_renders_and_mirror_matches_host_doc():
    log, expect = cases.random_text_log(5, 30, client_id=cases.BIG)
    ing, _ = run("torch", "apply_bytes", [[p, p] for p in log], 2)
    assert ing.fast_docs == 2 * len(log)
    for d in range(2):
        assert tbd.get_string(ing.state, d, ing.payloads) == expect
    host = Doc(client_id=99)
    for p in log:
        host.apply_update_v1(p)
    assert dict(ing.svs[0].clocks) == dict(host.state_vector().clocks)


def test_packed_ingest_equals_raw():
    """``ingest="packed"`` ships the host-padded matrix; the decoder sees
    the same bytes as the raw arena's gather."""
    log, expect = cases.xml_log(16)
    raw = TorchIngestor(1, cases.CAPACITY, device="cpu")
    packed = TorchIngestor(1, cases.CAPACITY, ingest="packed", device="cpu")
    for p in log:
        raw.apply_bytes([p])
        packed.apply_bytes([p])
    a, b = state_to_numpy(raw.state), state_to_numpy(packed.state)
    for plane in a:
        np.testing.assert_array_equal(a[plane], b[plane], err_msg=plane)
    assert packed.fast_docs == raw.fast_docs == len(log)


def test_delete_only_steps_retain_no_wire_bytes():
    log, _ = cases.text_log([("i", 0, "abcdef"), ("d", 1, 3), ("d", 0, 2)])
    ing = TorchIngestor(1, cases.CAPACITY, device="cpu")
    ing.apply_bytes([log[0]])
    kept = ing.payloads.total_bytes
    assert kept > 0
    ing.apply_bytes([log[1]])
    ing.apply_bytes([log[2]])
    assert ing.payloads.total_bytes == kept
    assert ing.fast_docs == 3


def test_start_from_a_snapshot_with_anchors():
    """Both ingestors start from one state that already holds root anchors
    (made by the port's `ensure_root_anchor_all` / `ensure_root_anchor`
    and carried across by `state_to_numpy`) and ingest a multi-root doc
    into two of its slots. The state has the fast-lane group's doc count,
    so ytpu reuses that group's compiled apply."""
    n = cases.combined(GROUPS["apply_bytes"])[0]
    st = tbd.init_state(n, cases.CAPACITY, "cpu")
    st = tbd.ensure_root_anchor_all(st, 0)
    st = tbd.ensure_root_anchor_all(st, 0)  # idempotent
    st = tbd.ensure_root_anchor(st, 1, 1)
    snap = state_to_numpy(st)
    assert snap["n_blocks"].tolist() == [1, 2] + [1] * (n - 2)
    j_state = jbd.ensure_root_anchor(jbd.ensure_root_anchor_all(jbd.init_state(n, cases.CAPACITY), 0), 1, 1)
    for plane, want in state_to_numpy(j_state).items():
        np.testing.assert_array_equal(snap[plane], want, err_msg=plane)
    log, _ = cases.multi_root_log()
    steps = [[p, p] + [None] * (n - 2) for p in log]
    j = run("jax", "apply_bytes", steps, n, start=snap)[1]
    t = run("torch", "apply_bytes", steps, n, start=snap)[1]
    assert t["svs"] == j["svs"]
    assert t["trees"] == j["trees"]
    same_lanes = j["lanes"][0] == t["lanes"][0]
    for plane, want in j["planes"].items():
        if same_lanes or plane not in CLIENT_PLANES + ("key", "content_ref"):
            np.testing.assert_array_equal(t["planes"][plane], want, err_msg=plane)
    assert t["trees"][0]["roots"]["title"] == t["trees"][1]["roots"]["title"]


def test_reset_slot_and_capacity_ledger():
    log, _ = cases.multi_root_log()
    ing = TorchIngestor(2, cases.CAPACITY, device="cpu")
    for p in log:
        ing.apply_bytes([p, p])
    live, dead, free = ing.capacity_ledger()
    assert (live + dead + free == cases.CAPACITY).all() and (live > 0).all()
    ing.reset_slot(0)
    assert int(ing.state.n_blocks[0]) == 0 and ing.svs[0].clocks == {} and 0 not in ing.primary_roots
    for p in log:
        ing.apply_bytes([p, None])
    a = tbd.get_tree(ing.state, 0, ing.payloads, ing.enc.keys)
    b = tbd.get_tree(ing.state, 1, ing.payloads, ing.enc.keys)
    assert a == b


def test_build_batch_matches_ytpu():
    """`BatchEncoder.build_batch` on host-decoded updates of two docs with
    other primary roots: every column of the padded batch, and the sticky
    per-slot primaries."""
    from ytpu.core import Update as JaxUpdate
    from ytpu.models.batch_doc import BatchEncoder as JaxEncoder

    from ytpu_torch.core.update import Update

    logs = [cases.multi_root_log()[0], cases.map_log()[0][:4] + cases.nested_log()[0][:3]]
    j_enc, t_enc = JaxEncoder(), tbd.BatchEncoder()
    for t in range(max(len(log) for log in logs)):
        ps = [log[t] if t < len(log) else None for log in logs]
        want = j_enc.build_batch([None if p is None else JaxUpdate.decode_v1(p) for p in ps], 8, 4)
        got = t_enc.build_batch([None if p is None else Update.decode_v1(p) for p in ps], 8, 4, device="cpu")
        for name in want._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                          err_msg=f"step {t} {name}")
    assert t_enc.doc_primaries == j_enc.doc_primaries == {0: "body", 1: "m"}
    assert t_enc.keys.ids == j_enc.keys.ids
    assert t_enc.interner.from_idx == j_enc.interner.from_idx


def test_v2_raises():
    """A V2 payload cut short raises in `apply(v2=True)`, in both packages,
    before any state changes."""
    from ytpu.encoding.lib0 import EncodingError as JaxEncodingError

    from ytpu_torch.encoding.lib0 import EncodingError

    ing = TorchIngestor(1, cases.CAPACITY, device="cpu")
    with pytest.raises(EncodingError):
        ing.apply([b"\x00\x00"], v2=True)
    with pytest.raises(JaxEncodingError):
        JaxIngestor(1, cases.CAPACITY).apply([b"\x00\x00"], v2=True)
    assert int(ing.state.n_blocks.sum()) == 0


# --- the chip_smoke ingest phase's committed logs -------------------------------------

LOGS_PATH = os.path.join(ROOT, "ytpu_torch", "benches", "data", "ingest_logs.json")


def ingest_logs_json() -> str:
    """The three logs of the ``ingest`` phase that ytpu's host `Doc`
    writes, with their final values: config 4's map + XML tenant
    (ytpu's ``benches/device.py::stream_workload_map_xml(300, seed=13)``),
    config 3's 256-client array (``stream_workload_array(256, 2,
    seed=11)``) and a text typed by a client with a 53-bit id."""
    from benches.device import stream_workload_array, stream_workload_map_xml

    xml = stream_workload_map_xml(n_steps=300, seed=13)
    host = Doc(client_id=99)
    for p in xml:
        host.apply_update_v1(p)
    frag = host.get_xml_fragment("x")
    array, array_expect = stream_workload_array(n_clients=256, ops_per_client=2, seed=11)
    big, big_expect = cases.random_text_log(17, 256, client_id=(1 << 52) + 12345)
    out = {
        "map_xml": {"log": [p.hex() for p in xml],
                    "expect": {"m": host.get_map("m").to_json(), "x": frag.get_string()}},
        "array": {"log": [p.hex() for p in array], "expect": array_expect},
        "big_client_text": {"log": [p.hex() for p in big], "expect": big_expect},
    }
    return json.dumps(out, indent=1, ensure_ascii=False) + "\n"


def test_committed_ingest_logs_regenerate():
    with open(LOGS_PATH, encoding="utf-8") as f:
        assert f.read() == ingest_logs_json()


def test_ingest_phase_expectations_on_the_cpu():
    """The phase's config 4 check on the CPU: the committed map + XML log
    through one doc of the port's host lane renders the fixture's map
    (`benches.ingest.root_map`) and XML string (`benches.ingest.xml_string`);
    and `step_payloads` gives each cohort its log, the B4 docs their lags
    and swapped pairs, and every cohort's whole log within the steps."""
    from ytpu_torch.benches import ingest as bench

    logs = bench.load_ingest_logs()
    ing = TorchIngestor(1, 512, device="cpu")
    for p in logs["map_xml"]["log"]:
        ing.apply([p])
    assert int(ing.state.error.max()) == 0 and ing.pending_update(0) is None
    tree = tbd.get_tree(ing.state, 0, ing.payloads, ing.enc.keys)
    assert bench.root_map(tree, ing.primary_roots[0], "m") == logs["map_xml"]["expect"]["m"]
    assert bench.xml_string(ing.state, 0, ing.payloads, ing.enc.keys, "x") == logs["map_xml"]["expect"]["x"]

    b4 = [bytes([i % 256, i // 256]) for i in range(bench.INGEST_STEPS)]
    got = {d: [] for d in range(bench.INGEST_DOCS)}
    for t in range(bench.INGEST_STEPS):
        for d, p in enumerate(bench.step_payloads(t, b4, logs)):
            if p is not None:
                got[d].append(p)
    assert sum(n for _, _, n in bench.COHORTS) == bench.INGEST_DOCS
    for name, first, n in bench.COHORTS:
        for d in range(first, first + n):
            if name == "b4":
                want = b4[: bench.b4_prefix(d)]
                assert sorted(got[d]) == sorted(want) and len(want) % 2 == 0
                assert (got[d] == want) != bench.b4_swapped(d)
            else:
                assert got[d] == logs[name]["log"]
    swapped = sum(bench.b4_swapped(d) for d in range(768))
    assert swapped == 96 and {bench.b4_doc_lag(d) for d in range(768) if bench.b4_swapped(d)} == {
        bench.b4_doc_lag(g) for g in range(bench.LAG_GROUPS)}


if __name__ == "__main__":
    with open(LOGS_PATH, "w", encoding="utf-8") as f:
        f.write(ingest_logs_json())
