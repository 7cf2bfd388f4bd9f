"""The port's device-decoded payload readers against the JAX package's on
the CPU: `RawPayloadView` (Any, Json, Embed, Binary, Format and Type spans
of the wire-byte matrix) and `UnitArenaView.slice_values`, each read
directly and through the diff finisher.

Each log is decoded by `decode_updates_v1` in both packages (every log in
one wire matrix, so one decode and one ytpu apply program serve all),
applied on the CPU by `apply_update_stream` to a doc of its own, and
finished against an empty remote and a mid-history state vector through
``EncoderTables.identity(n, view)``: the port's bytes must equal ytpu's.
Tolerance: none, the outputs are bytes and int32 states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ytpu.core import Doc
from ytpu.models import batch_doc as jbd
from ytpu.models import replay as jreplay
from ytpu.ops import decode_kernel as jdk

from ytpu_torch.core.content import CONTENT_ANY, CONTENT_EMBED, CONTENT_FORMAT, CONTENT_STRING
from ytpu_torch.encoding import lib0 as tlib0
from ytpu_torch.models import batch_doc as tbd
from ytpu_torch.models import replay as treplay
from ytpu_torch.ops import decode_kernel as tdk

from _torch_sync_cases import capture, field_diffs

torch.set_num_threads(1)

N_CLIENTS, CAPACITY, ROWS, DELS = 8, 64, 8, 4


def any_roadmap():
    """ROADMAP C.1's case: one doc inserts three Any values into an array."""
    doc = Doc(client_id=1)
    log = capture(doc)
    with doc.transact() as txn:
        doc.get_array("text").insert_range(txn, 0, [1, "two", 3.5])
    return log


def any_split():
    """An Any row split by later inserts and by a delete inside it, so the
    state holds Any rows whose content starts at an offset."""
    doc = Doc(client_id=2)
    log = capture(doc)
    arr = doc.get_array("text")
    with doc.transact() as txn:
        arr.insert_range(txn, 0, [1, "two", 3.5, None, True, {"k": 1, "j": "s"}, [1, "x"], -7, 2**40])
    with doc.transact() as txn:
        arr.insert(txn, 3, "mid")
    with doc.transact() as txn:
        arr.remove_range(txn, 5, 2)
    with doc.transact() as txn:
        arr.insert_range(txn, 1, [False, 0.25])
    return log


def formatted_text():
    """Text with Format marks (a range formatted, an insert with
    attributes) and an Embed."""
    doc = Doc(client_id=3)
    log = capture(doc)
    t = doc.get_text("text")
    with doc.transact() as txn:
        t.insert(txn, 0, "hello world")
    with doc.transact() as txn:
        t.format(txn, 0, 5, {"bold": True})
    with doc.transact() as txn:
        t.insert_with_attributes(txn, 11, "!", {"italic": {"x": 1}})
    with doc.transact() as txn:
        t.insert_embed(txn, 6, {"img": "a.png"})
    return log


def surrogate_text():
    """Text with surrogate pairs, split by inserts and deletes."""
    doc = Doc(client_id=4)
    log = capture(doc)
    t = doc.get_text("text")
    with doc.transact() as txn:
        t.insert(txn, 0, "a\U0001F600b\U0001F680cd")
    with doc.transact() as txn:
        t.insert(txn, 4, "XY")
    with doc.transact() as txn:
        t.remove_range(txn, 1, 2)
    return log


LOGS = {"any_roadmap": any_roadmap, "any_split": any_split, "format_ref_below_0": formatted_text,
        "unit_arena": surrogate_text}
REMOTES = ["empty", "mid"]


@pytest.fixture(scope="module")
def decoded():
    """Every log in one wire matrix, decoded once by each package; per log
    its update range and the host text or array of its doc."""
    logs = {name: make() for name, make in LOGS.items()}
    payloads = [p for lg in logs.values() for p in lg]
    cols = [tlib0.update_columns(p) for p in payloads]
    steps = max(tdk.steps_for_columns(c) for c in cols)
    sections = max(c.n_client_sections for c in cols)
    buf, lens = tdk.pack_updates(payloads)
    j_stream, j_flags = jdk.decode_updates_v1(jnp.asarray(buf), jnp.asarray(lens), max_rows=ROWS,
                                              max_dels=DELS, n_steps=steps, max_sections=sections)
    t_stream, t_flags = tdk.decode_updates_v1(torch.from_numpy(buf), torch.from_numpy(lens), max_rows=ROWS,
                                              max_dels=DELS, n_steps=steps, max_sections=sections)
    assert not (np.asarray(j_flags) & jdk.FLAG_ERRORS).any()
    assert np.array_equal(t_flags.numpy(), np.asarray(j_flags))
    spans, at = {}, 0
    for name, lg in logs.items():
        spans[name] = (at, at + len(lg))
        at += len(lg)
    return logs, buf, j_stream, t_stream, spans


def _apply(decoded, name, refs=None):
    """Log `name` applied to a fresh doc in each package (``refs``, where
    given, replaces the decoded refs that are >= 0, as the replay rebases
    string rows onto its unit arena); returns (ytpu state, port state)."""
    logs, buf, j_stream, t_stream, spans = decoded
    keep = np.zeros(buf.shape[0], dtype=bool)
    keep[slice(*spans[name])] = True
    if refs is not None:
        j_stream = j_stream._replace(content_ref=jnp.where(refs >= 0, refs, j_stream.content_ref))
        t_stream = t_stream._replace(content_ref=torch.where(torch.from_numpy(refs) >= 0,
                                                             torch.from_numpy(refs), t_stream.content_ref))
    j_stream = j_stream._replace(valid=j_stream.valid & keep[:, None],
                                 del_valid=j_stream.del_valid & keep[:, None])
    keep_t = torch.from_numpy(keep)
    t_stream = t_stream._replace(valid=t_stream.valid & keep_t[:, None],
                                 del_valid=t_stream.del_valid & keep_t[:, None])
    js = jbd.apply_update_stream(jbd.init_state(1, CAPACITY), j_stream, jdk.identity_rank(256))
    ts = tbd.apply_update_stream(tbd.init_state(1, CAPACITY, "cpu"), t_stream, tdk.identity_rank(256, "cpu"))
    assert int(np.asarray(js.error).max()) == 0
    assert field_diffs(tbd.ensure_origin_slot(ts), js) == []
    return js, ts


def _with_column(js, ts, name, values):
    """Both states with block column `name` replaced by `values` ([1, B])."""
    js = js._replace(blocks=js.blocks._replace(**{name: jnp.asarray(values)}))
    ts = ts._replace(blocks=ts.blocks._replace(**{name: torch.from_numpy(values)}))
    return js, ts


def _remote(ts, kind):
    if kind == "empty":
        return np.zeros((1, N_CLIENTS), dtype=np.int32)
    return tbd.state_vectors(ts, N_CLIENTS).numpy() // 2


def _finish_both(js, ts, sv, j_view, t_view):
    """ytpu's finisher over its view and the port's over its own, each on
    its own package's selection of the rows `sv` lacks."""
    want_sel = [np.array(a) for a in jbd.encode_diff_batch(js, jnp.asarray(sv), N_CLIENTS)]
    ship, off, local_sv, dele = tbd.encode_diff_batch(ts, torch.from_numpy(sv), N_CLIENTS)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip((ship, off, local_sv, dele), want_sel))
    want = jbd.finish_encode_diff(js, 0, *want_sel[:2], want_sel[3], tbd.EncoderTables.identity(N_CLIENTS, j_view))
    got = tbd.finish_encode_diff_batch(ts, [0], ship, off, dele, tbd.EncoderTables.identity(N_CLIENTS, t_view))
    return want, got[0]


@pytest.mark.parametrize("remote", REMOTES)
@pytest.mark.parametrize("name", ["any_roadmap", "any_split"])
def test_any_rows_finish_as_in_jax(decoded, name, remote):
    """Any rows, whole and split by an offset, finished through each
    package's `RawPayloadView.slice_values`; the full diff rebuilds the
    array in a host doc."""
    logs, buf = decoded[0], decoded[1]
    js, ts = _apply(decoded, name)
    kinds = ts.blocks.kind[0, : int(ts.n_blocks[0])]
    assert bool((kinds == CONTENT_ANY).any())
    if name == "any_split":
        assert bool(((kinds == CONTENT_ANY) & (ts.blocks.content_off[0, : len(kinds)] > 0)).any())
    want, got = _finish_both(js, ts, _remote(ts, remote), jdk.RawPayloadView(buf), tdk.RawPayloadView(buf))
    assert got == want
    if remote == "empty":
        host, replica = Doc(), Doc(client_id=99)
        for p in logs[name]:
            host.apply_update_v1(p)
        replica.apply_update_v1(got)
        assert replica.get_array("text").to_json() == host.get_array("text").to_json()
        if name == "any_roadmap":
            assert got == logs[name][0]  # the update's own bytes, as ytpu returns them


@pytest.mark.parametrize("remote", REMOTES)
def test_format_rows_with_a_ref_below_0_finish_as_in_jax(decoded, remote):
    """Format and Embed rows whose ref is below 0 take the finisher's wire
    readers (`format_kv`, `embed_value`). The view slices its flat buffer
    as Python does, so ``ref - len(buf)`` addresses the byte at ``ref``:
    every such row's ref is moved below 0 in both states."""
    logs, buf = decoded[0], decoded[1]
    js, ts = _apply(decoded, "format_ref_below_0")
    kind = ts.blocks.kind.numpy()
    marked = (kind == CONTENT_FORMAT) | (kind == CONTENT_EMBED)
    assert int((kind == CONTENT_FORMAT).sum()) >= 2 and int((kind == CONTENT_EMBED).sum()) == 1
    refs = ts.blocks.content_ref.numpy()
    js, ts = _with_column(js, ts, "content_ref", np.where(marked, refs - buf.size, refs).astype(np.int32))
    want, got = _finish_both(js, ts, _remote(ts, remote), jdk.RawPayloadView(buf), tdk.RawPayloadView(buf))
    assert got == want
    if remote == "empty":
        host, replica = Doc(), Doc(client_id=99)
        for p in logs["format_ref_below_0"]:
            host.apply_update_v1(p)
        replica.apply_update_v1(got)
        assert replica.get_text("text").diff() == host.get_text("text").diff()


def _plans(decoded):
    logs = decoded[0]
    return jreplay.plan_replay(logs["unit_arena"]), treplay.plan_replay(logs["unit_arena"])


def test_unit_arena_slice_values_match_jax(decoded):
    """Every row's characters, whole and at each split, from each
    package's `UnitArenaView.slice_values` on the same plan."""
    jplan, tplan = _plans(decoded)
    assert np.array_equal(jplan.unit_byte, tplan.unit_byte) and jplan.arena == tplan.arena
    jview = jreplay.UnitArenaView(jplan.unit_byte, jplan.arena)
    tview = treplay.UnitArenaView(tplan.unit_byte, tplan.arena)
    units = len(tplan.unit_byte) - 1
    for ref in tplan.unit_refs[tplan.unit_refs >= 0].tolist():
        for off in range(units - ref):
            for length in range(units - ref - off + 1):
                assert tview.slice_values(ref, off, length) == jview.slice_values(ref, off, length)


@pytest.mark.parametrize("remote", REMOTES)
def test_unit_arena_rows_finish_as_in_jax(decoded, remote):
    """The text log rebased onto each package's unit arena, as the replay
    does, its string rows relabelled Any in both states, so that each
    finisher reads them through `UnitArenaView.slice_values`."""
    jplan, tplan = _plans(decoded)
    logs, buf, _, _, spans = decoded
    s0, s1 = spans["unit_arena"]
    refs = np.full((buf.shape[0], ROWS), -1, dtype=np.int32)
    refs[s0:s1, : tplan.unit_refs.shape[1]] = tplan.unit_refs
    js, ts = _apply(decoded, "unit_arena", refs)
    kind = ts.blocks.kind.numpy()
    assert int((kind == CONTENT_STRING).sum()) >= 3
    js, ts = _with_column(js, ts, "kind", np.where(kind == CONTENT_STRING, CONTENT_ANY, kind).astype(np.int32))
    want, got = _finish_both(js, ts, _remote(ts, remote), jreplay.UnitArenaView(jplan.unit_byte, jplan.arena),
                             treplay.UnitArenaView(tplan.unit_byte, tplan.arena))
    assert got == want


def _spans():
    """Hand-written wire spans of each reader: (name, bytes, args)."""
    w = tlib0.Writer()
    w.write_var_uint(3)
    for s in ('{"a":1}', "[2,3]", "not json"):
        w.write_string(s)
    json_span = w.to_bytes()
    w = tlib0.Writer()
    tlib0.write_any(w, {"k": [1, None]})
    tlib0.write_any(w, "s")
    tlib0.write_any(w, 2.5)
    countless = w.to_bytes()
    w = tlib0.Writer()
    w.write_buf(b"\x00\x01\xff")
    binary = w.to_bytes()
    w = tlib0.Writer()
    w.write_string('{"src":"x"}')
    embed = w.to_bytes()
    w = tlib0.Writer()
    w.write_u8(3)
    w.write_string("p")
    xml_element = w.to_bytes()
    return [
        ("json_values", json_span, (1, 2)), ("json_raw", json_span, (0, 3)),
        ("slice_values_v2", countless, (1, 2)), ("binary_value", binary, ()),
        ("embed_value", embed, ()), ("type_branch", xml_element, ()), ("type_raw", xml_element, ()),
        ("type_branch", b"\x01", ()), ("type_raw", b"\x01", ()),
    ]


@pytest.mark.parametrize("case", range(len(_spans())))
def test_wire_readers_match_jax(case):
    """Each reader of `RawPayloadView` on a span placed after 5 bytes of
    padding in both packages' views."""
    name, span, args = _spans()[case]
    buf = np.frombuffer(b"\x07" * 5 + span + b"\x00" * 4, dtype=np.uint8)
    v2 = name == "slice_values_v2"
    method = "slice_values" if v2 else name
    want = getattr(jdk.RawPayloadView(buf, v2_any=v2), method)(5, *args)
    got = getattr(tdk.RawPayloadView(buf, v2_any=v2), method)(5, *args)
    if name == "type_branch":
        assert (got.type_ref, got.type_name) == (want.type_ref, want.type_name)
    else:
        assert got == want
